// K4a and K4b on Hopper: the Mandelbulb raymarcher's cone prepass and its
// march + shading kernel.
//
// Replaces fractalrenderer_tpu/ops/bulb_kernel.py:_make_cone_kernel (K4a,
// pallas_call at :349) and :_make_kernel (K4b, pallas_call at :911) with
// its flat march (_flat_march :359-483), esc recovery (:777-785) and flat
// shading walk (_flat_shade :486-634).  The DE steps are
// ops/bulb_math.py:de_step (with the ops/trig.py polynomials) and
// :de_step_int.  The plain PyTorch versions are
// fractalrenderer_tpu_torch/ops/bulb_kernel.py:cone_fields_plain and
// :march_fields_plain; the kernels agree with them bit for bit.
//
// What bounds it.  f32 issue over the DE orbits: one DE step is 58 f32
// operations on the integer-power path (power 8) and ~80 with the trig
// polynomials and powf/sinf/cosf, and the default 1080p frame needs ~7e7
// of them (most in near-surface orbits, which run until dr overflows or
// the iteration limit).  Bytes are negligible: 4 B of t0 read and 32 B
// (plus 8 with stats) written per pixel.  Divergence between the lanes of
// a warp is the other cost: a warp steps until its slowest lane is done.
//
// Design.  One thread per lane (a coarse cone block for K4a, a pixel for
// K4b), each running its own orbit schedule: the TPU kernels' tile loops,
// DE_CHUNK bursts and cross-lane any() exits have nothing to carry over.
// The flat form's per-lane trajectory is kept exactly, with its exact
// dr-overflow orbit exit (de_finish returns +-0 once dr is +inf, and no
// consumer tells them apart).  K4b runs every phase of a pixel -- the march,
// the one full-length orbit that recovers esc at the hit, the 3 normal taps
// and the 8 AO taps -- in ONE loop around ONE DE-step site, so lanes of a
// warp in different phases still share the step's instructions; each trip
// either steps the lane's live orbit or handles the event of the orbit that
// just ended.  The march caps a lane at MAX_STEPS evaluations, every one
// counted (the nested form's bound, bulb_kernel.py:681-683).  Each warp
// covers an 8x4 pixel patch (blocks of 32x8 pixels), so its rays stay close
// and diverge less than a 32x1 row would.  The power is a template
// parameter: 2..16 take the trig-free integer step, whose square-and-multiply
// chains unroll at compile time in the JAX package's multiplication order
// into straight-line code (a runtime bit loop would branch on the power in
// every DE step; what that costs is not measured), and 0 takes the trig
// step with the runtime power: 16 instances of each kernel, every one held
// against the plain version on the card (chip_smoke.py,
// tests/test_torch_cuda.py).
//
// Exactness.  Build with -fmad=false and without --use_fast_math: IEEE
// division and sqrtf, subnormals kept, f32 literals equal to
// numpy.float32 of the Python constants, and NaN-propagating max/min/clamp
// as torch.maximum/clamp have.

#include <cuda_runtime.h>

#include <cstring>

namespace {

// March vector (bulb_kernel.py:36-38) and the cone vector's extra slots
// (:206-207).
constexpr int kNB = 9, kNCB = 11;
enum { B_ROX, B_ROY, B_ROZ, B_FOV, B_POWER, B_LIMIT, B_OFFX, B_OFFY,
       B_ROW0 };
constexpr int C_STEP = 9, C_BETA = 10;

constexpr int kMaxSteps = 200;     // bulb_math.MAX_STEPS
constexpr float kMaxDist = 10.0f;  // bulb_math.MAX_DIST
constexpr float kOmega = 1.6f;     // bulb_kernel.OMEGA
constexpr float kRelaxCutoff = 8.0f;
constexpr float kInf = __builtin_huge_valf();

// numpy.float32(math.pi) and numpy.float32(math.pi / 2) (ops/trig.py).
constexpr float kPi = 3.14159274f;
constexpr float kPi2 = 1.57079637f;

// K4b's phases: the march, the esc-recovery orbit, the 11 shading taps.
constexpr int kMarch = 0, kEsc = 1, kTap0 = 2, kNTaps = 11;

struct MarchParams {
  float v[kNB];
};
struct ConeParams {
  float v[kNCB];
};

// torch.maximum / torch.clamp: NaN-propagating.
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tclamp(float x, float lo, float hi) {
  return (x != x) ? x : fminf(fmaxf(x, lo), hi);
}

// ops/trig.py atan / atan2 / acos.
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

__device__ __forceinline__ float poly_acos(float x) {
  const float xc = tclamp(x, -1.0f, 1.0f);
  return poly_atan2(sqrtf(tmax(1.0f - xc * xc, 0.0f)), xc);
}

// bulb_math.ray_dirs: the camera basis from ro, then one pixel's direction.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray ray_dir(const float* v, float px, float py,
                                       int width, int height) {
  const float rox = v[B_ROX], roy = v[B_ROY], roz = v[B_ROZ];
  const float fov = v[B_FOV];
  const float fh = static_cast<float>(height);
  const float ux = (px - static_cast<float>(width) * 0.5f) / fh;
  const float uy = (py - fh * 0.5f) / fh;
  const float rlen = sqrtf(rox * rox + roy * roy + roz * roz);
  const float f0 = -rox / rlen, f1 = -roy / rlen, f2 = -roz / rlen;
  const float rx = f2, rz = -f0;
  const float rl = tmax(sqrtf(rx * rx + rz * rz), 1e-12f);
  const float r0 = rx / rl, r1 = 0.0f, r2 = rz / rl;
  const float u0 = f1 * r2 - f2 * r1;
  const float u1 = f2 * r0 - f0 * r2;
  const float u2 = f0 * r1 - f1 * r0;
  const float dx = f0 + r0 * ux * fov + u0 * uy * fov;
  const float dy = f1 + r1 * ux * fov + u1 * uy * fov;
  const float dz = f2 + r2 * ux * fov + u2 * uy * fov;
  const float inv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  return {rox, roy, roz, dx * inv, dy * inv, dz * inv};
}

// bulb_math._cpow_int: (cr + i ci)^p, square-and-multiply from the lowest
// bit up; with a compile-time p the loop unrolls to the JAX chain.
__device__ __forceinline__ void cpow_int(float cr, float ci, int p, float& rr,
                                         float& ri) {
  float br = cr, bi = ci;
  bool have = false;
#pragma unroll
  for (int bit = 0; bit < 5; ++bit) {
    if (p == 0) break;
    if (p & 1) {
      if (!have) {
        rr = br;
        ri = bi;
        have = true;
      } else {
        const float nr = rr * br - ri * bi;
        const float ni = rr * bi + ri * br;
        rr = nr;
        ri = ni;
      }
    }
    p >>= 1;
    if (p) {
      const float nbr = (br - bi) * (br + bi);
      const float nbi = 2.0f * br * bi;
      br = nbr;
      bi = nbi;
    }
  }
}

// bulb_math._rpow_int: r^k by the top-down recursion (k -> k/2 until 1 or
// 2, then square on the way back, times r at odd k).
template <int K>
__device__ __forceinline__ float rpow_int(float r, float r2) {
  if constexpr (K == 1) {
    return r;
  } else if constexpr (K == 2) {
    return r2;
  } else {
    float h = rpow_int<K / 2>(r, r2);
    h = h * h;
    if constexpr (K & 1) h = h * r;
    return h;
  }
}

// One DE iteration on a live orbit: bulb_math.de_step_int for kP in 2..16,
// bulb_math.de_step (polynomial acos/atan2) for kP == 0.  r is the carried
// |z| = sqrtf(zx^2 + zy^2 + zz^2).
template <int kP>
__device__ __forceinline__ void de_step(float& zx, float& zy, float& zz,
                                        float& dr, float r, float px,
                                        float py, float pz, float power) {
  if constexpr (kP == 0) {
    const float rs = tmax(r, 1e-12f);
    const float theta = poly_acos(tclamp(zz / rs, -1.0f, 1.0f));
    const float phi = poly_atan2(zy, zx);
    const float r_pow = powf(rs, power - 1.0f);
    const float ndr = r_pow * power * dr + 1.0f;
    const float zr = powf(rs, power);
    const float th = theta * power;
    const float ph = phi * power;
    const float st = sinf(th);
    const float nzx = zr * (st * cosf(ph)) + px;
    const float nzy = zr * (sinf(ph) * st) + py;
    const float nzz = zr * cosf(th) + pz;
    zx = nzx;
    zy = nzy;
    zz = nzz;
    dr = ndr;
  } else {
    const float m2 = zx * zx + zy * zy;
    const float r2 = m2 + zz * zz;
    const bool zero_m = m2 <= 0.0f;
    const float inv_m = 1.0f / sqrtf(zero_m ? 1.0f : m2);
    const float cph = zero_m ? 1.0f : zx * inv_m;
    const float sph = zero_m ? 0.0f : zy * inv_m;
    const float m = zero_m ? 0.0f : m2 * inv_m;
    float upr, upi, cpp, spp;
    cpow_int(zz, m, kP, upr, upi);
    cpow_int(cph, sph, kP, cpp, spp);
    const float r_pow = rpow_int<kP - 1>(r, r2);
    const float ndr = r_pow * static_cast<float>(kP) * dr + 1.0f;
    zx = upi * cpp + px;
    zy = spp * upi + py;
    zz = upr + pz;
    dr = ndr;
  }
}

// bulb_math.de_finish.
__device__ __forceinline__ float de_finish(float r, float dr) {
  const float de = 0.5f * logf(tmax(r, 1e-12f)) * r / tmax(dr, 1e-12f);
  return (r < 1e-4f || dr < 1e-4f) ? 0.0f : de;
}

// A lane's orbit: the DE iteration from position p, its state and count.
struct Orbit {
  float px, py, pz, zx, zy, zz, dr, r;
  int oi;   // iterations done
  int esc;  // _de_tile's escape index (-1 until recorded)

  __device__ __forceinline__ void start(float x, float y, float z) {
    px = zx = x;
    py = zy = y;
    pz = zz = z;
    dr = 1.0f;
    r = sqrtf(x * x + y * y + z * z);
    oi = 0;
    esc = r > 2.0f ? 0 : -1;
  }

  // _flat_march's orbit_act (with the dr-overflow exit) or _de_tile's act
  // (full length, for the esc recovery).
  __device__ __forceinline__ bool live(int limit, bool full_length) const {
    return r <= 2.0f && r >= 1e-4f && oi < limit &&
           (full_length || dr < kInf);
  }

  template <int kP>
  __device__ __forceinline__ void step(int limit, float power) {
    de_step<kP>(zx, zy, zz, dr, r, px, py, pz, power);
    r = sqrtf(zx * zx + zy * zy + zz * zz);
    // _de_tile records the escape at the update that made it, below limit
    if (esc < 0 && r > 2.0f && oi + 1 < limit) esc = oi + 1;
    ++oi;
  }
};

// Each warp covers an 8x4 lane patch of a block's 32x8 lanes.
__device__ __forceinline__ void lane_xy(int& x, int& y) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x = blockIdx.x * 32 + (warp & 3) * 8 + (lane & 7);
  y = blockIdx.y * 8 + (warp >> 2) * 4 + (lane >> 3);
}

// K4a: _make_cone_kernel.  One lane per coarse cone x cone block (row
// index counted from the band's first coarse row, B_ROW0 = start_c):
// march the block-centre ray with the hit threshold inflated to
// max(1e-4, 1e-3 t, 3 beta t); write the stop t, or 0.001 after a NaN stop.
// The minimum of 1 block per SM lets ptxas use 40 registers for the trig
// instance; with the bound of 256 threads alone it chose 32 and spilled.
template <int kP>
__global__ void __launch_bounds__(256, 1)
    bulb_cone_kernel(ConeParams p, int coarse_w, int coarse_h, int width,
                     int map_height, float* __restrict__ t0_out) {
  int ccol, crow;
  lane_xy(ccol, crow);
  if (ccol >= coarse_w || crow >= coarse_h) return;
  const float* v = p.v;
  const float cs = v[C_STEP], beta = v[C_BETA];
  const float pxf = static_cast<float>(ccol) * cs + v[B_OFFX] +
                    (cs - 1.0f) * 0.5f;
  const float pyf = (static_cast<float>(crow) + v[B_ROW0]) * cs + v[B_OFFY] +
                    (cs - 1.0f) * 0.5f;
  const Ray ray = ray_dir(v, pxf, pyf, width, map_height);
  const float power = v[B_POWER];
  const int limit = static_cast<int>(v[B_LIMIT]);

  float t = 0.001f;
  int mstep = 0;
  bool bad_f = false;
  Orbit o;
  o.start(ray.ox + ray.dx * t, ray.oy + ray.dy * t, ray.oz + ray.dz * t);
  for (;;) {
    if (o.live(limit, false)) {
      o.step<kP>(limit, power);
      continue;
    }
    const float d = de_finish(o.r, o.dr);
    const bool bad = !isfinite(d);
    const float thr = tmax(tmax(1e-4f, 1e-3f * t), 3.0f * beta * t);
    const bool stop = bad || d < thr || t > kMaxDist || d > kMaxDist;
    bad_f = bad_f || bad;
    ++mstep;
    if (!stop) t = t + tmax(d * 0.5f, 0.0005f);
    if (stop || mstep >= kMaxSteps) break;
    o.start(ray.ox + ray.dx * t, ray.oy + ray.dy * t, ray.oz + ray.dz * t);
  }
  t0_out[static_cast<size_t>(crow) * coarse_w + ccol] = bad_f ? 0.001f : t;
}

struct MarchOut {
  float *hit, *t, *d, *esc, *nx, *ny, *nz, *ao, *msteps, *work;
};

// K4b: _make_kernel's flat production path, one pixel per lane.
template <int kP>
__global__ void __launch_bounds__(256)
    bulb_march_kernel(MarchParams p, const float* __restrict__ tc,
                      int coarse_w, int cone, int width, int height,
                      int map_height, int shade, MarchOut out) {
  int col, lrow;
  lane_xy(col, lrow);
  if (col >= width || lrow >= height) return;
  const float* v = p.v;
  const int row0 = static_cast<int>(v[B_ROW0]);
  const Ray ray = ray_dir(v, static_cast<float>(col) + v[B_OFFX],
                          static_cast<float>(lrow + row0) + v[B_OFFY], width,
                          map_height);
  const float power = v[B_POWER];
  const int limit = static_cast<int>(v[B_LIMIT]);

  // start depth: the cone prepass's t of this pixel's image-aligned block
  float t = 0.001f;
  if (tc != nullptr) {
    const int frac = row0 % cone;  // row0 - floor(row0 / cone) * cone
    const float tb =
        __ldg(tc + static_cast<size_t>((frac + lrow) / cone) * coarse_w +
              col / cone);
    t = tmax(tb, 0.001f);
  }

  // march state (_flat_march)
  int mstep = 0;
  bool hit = false, relax = true, rel_prev = false;
  float d_hit = 0.0f, prev_step = 0.0f, prev_rad = kInf;
  // shading state (_flat_shade)
  float esc_hit = 0.0f, hx = 0.0f, hy = 0.0f, hz = 0.0f;
  float dxp = 0.0f, dyp = 0.0f, dzp = 0.0f;
  float nx = 0.0f, ny = 1.0f, nz = 0.0f, ao = 0.0f, kf = 0.0f;
  int work = 0;

  int phase = kMarch;
  Orbit o;
  o.start(ray.ox + ray.dx * t, ray.oy + ray.dy * t, ray.oz + ray.dz * t);
  for (;;) {
    if (o.live(limit, phase == kEsc)) {
      o.step<kP>(limit, power);
      ++work;
      continue;
    }
    // the orbit ended: this phase's event, then the next orbit's start
    const float d = de_finish(o.r, o.dr);
    float sx, sy, sz;
    if (phase == kMarch) {
      ++mstep;
      const bool bad = !isfinite(d);
      const float rad = 0.5f * d;
      // overshoot of the previous relaxed step: revert, relax off
      const bool over_b = rel_prev && (bad || prev_step > prev_rad + rad);
      const bool usable = !over_b;
      const float thr = tmax(1e-4f, 1e-3f * t);
      const bool hit_now = usable && !bad && d < thr;
      if (hit_now) {
        hit = true;
        d_hit = d;
      }
      const bool out_ = t > kMaxDist || d > kMaxDist;
      const bool ended = hit_now || (usable && (bad || out_));
      const bool still = usable && !ended;
      const bool relax_now = relax && d > kRelaxCutoff * thr;
      const float step_n = tmax(relax_now ? kOmega * rad : rad, 0.0005f);
      if (still) {
        t = t + step_n;
        prev_step = step_n;
        prev_rad = rad;
        rel_prev = relax_now;
      } else if (over_b) {
        t = t - prev_step + prev_rad;
        prev_step = prev_rad;
        relax = false;
        rel_prev = false;
      }
      sx = ray.ox + ray.dx * t;
      sy = ray.oy + ray.dy * t;
      sz = ray.oz + ray.dz * t;
      if (ended || mstep >= kMaxSteps) {
        if (!hit) break;
        phase = kEsc;  // recover esc from one full-length orbit at the hit
        hx = sx;
        hy = sy;
        hz = sz;
      }
    } else if (phase == kEsc) {
      esc_hit = o.esc < 0 ? static_cast<float>(limit)
                          : static_cast<float>(o.esc);
      if (!shade) break;
      phase = kTap0;
      sx = hx + 1e-3f;
      sy = hy;
      sz = hz;
    } else {
      const int k = phase - kTap0;
      if (k == 0) {
        dxp = d;
        sx = hx;
        sy = hy + 1e-3f;
        sz = hz;
      } else if (k == 1) {
        dyp = d;
        sx = hx;
        sy = hy;
        sz = hz + 1e-3f;
      } else {
        if (k == 2) {
          // the normal by forward differences (d0 = d_hit)
          dzp = d;
          const float nxr = dxp - d_hit, nyr = dyp - d_hit, nzr = dzp - d_hit;
          float nl = sqrtf(nxr * nxr + nyr * nyr + nzr * nzr);
          const bool fb = nl < 1e-4f;
          nl = tmax(nl, 1e-12f);
          nx = fb ? 0.0f : nxr / nl;
          ny = fb ? 1.0f : nyr / nl;
          nz = fb ? 0.0f : nzr / nl;
          kf = 0.01f;  // the shader's f32 loop: k = 0.01, += 0.02, < 0.15
        } else {
          ao = ao + expf(-10.0f * d);
          kf = kf + 0.02f;
        }
        if (k == kNTaps - 1) break;
        sx = hx + nx * kf;
        sy = hy + ny * kf;
        sz = hz + nz * kf;
      }
      ++phase;
    }
    o.start(sx, sy, sz);
  }

  if (shade && !hit) {
    // _flat_shade's closed form for non-hit lanes: parked at (3, 0, 0)
    // with d0 = 0, every tap orbit is dead on arrival
    const float far = 3.0f, zero = 0.0f, eps = 1e-3f, one = 1.0f;
    auto dead_de = [&](float x, float y, float z) {
      return de_finish(sqrtf(x * x + y * y + z * z), one);
    };
    const float nxr = dead_de(far + eps, zero, zero) - zero;
    const float nyr = dead_de(far, zero + eps, zero) - zero;
    const float nzr = dead_de(far, zero, zero + eps) - zero;
    float nl = sqrtf(nxr * nxr + nyr * nyr + nzr * nzr);
    const bool fb = nl < 1e-4f;
    nl = tmax(nl, 1e-12f);
    nx = fb ? zero : nxr / nl;
    ny = fb ? one : nyr / nl;
    nz = fb ? zero : nzr / nl;
    ao = 0.0f;
    float k = 0.01f;
    for (int i = 0; i < kNTaps - 3; ++i) {
      ao = ao + expf(-10.0f * dead_de(far + nx * k, zero + ny * k,
                                      zero + nz * k));
      k = k + 0.02f;
    }
  }

  const size_t idx = static_cast<size_t>(lrow) * width + col;
  out.hit[idx] = hit ? 1.0f : 0.0f;
  out.t[idx] = t;
  out.d[idx] = d_hit;
  out.esc[idx] = esc_hit;
  if (shade) {
    out.nx[idx] = nx;
    out.ny[idx] = ny;
    out.nz[idx] = nz;
    out.ao[idx] = ao;
  }
  if (out.msteps != nullptr) {
    out.msteps[idx] = static_cast<float>(mstep);
    out.work[idx] = static_cast<float>(work);
  }
}

dim3 grid_for(int w, int h) { return dim3((w + 31) / 32, (h + 7) / 8); }

// The power's instance: 0 (trig step) or 2..16 (integer step).
#define FR_BULB_POWERS(X) \
  X(0) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)

}  // namespace

extern "C" {

// Launch K4a on `stream`: `params` is the 11-float cone vector (host array,
// copied into the by-value argument), `power` the instance (0 = trig step,
// 2..16 = integer step); writes t0 (coarse_h, coarse_w) f32, row-major.
// Returns the cudaError_t of the launch.
int fr_bulb_cone(int power, const float* params, int coarse_w, int coarse_h,
                 int width, int map_height, void* t0_out, void* stream) {
  ConeParams p;
  std::memcpy(p.v, params, sizeof(p.v));
  const auto s = static_cast<cudaStream_t>(stream);
  auto* t0 = static_cast<float*>(t0_out);
  switch (power) {
#define FR_CASE(P)                                                     \
  case P:                                                              \
    bulb_cone_kernel<P><<<grid_for(coarse_w, coarse_h), 256, 0, s>>>( \
        p, coarse_w, coarse_h, width, map_height, t0);                 \
    break;
    FR_BULB_POWERS(FR_CASE)
#undef FR_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch K4b on `stream`: `params` is the 9-float march vector; `tc` the
// K4a grid (coarse_w wide, cone x cone blocks) or null for t0 = 0.001;
// writes hit, t, d, esc and, with `shade`, nx, ny, nz, ao, and, where
// `msteps` is not null, msteps and work, each (height, width) f32.
int fr_bulb_march(int power, const float* params, const void* tc,
                  int coarse_w, int cone, int width, int height,
                  int map_height, int shade, void* hit, void* t, void* d,
                  void* esc, void* nx, void* ny, void* nz, void* ao,
                  void* msteps, void* work, void* stream) {
  MarchParams p;
  std::memcpy(p.v, params, sizeof(p.v));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* tcp = static_cast<const float*>(tc);
  const MarchOut out = {static_cast<float*>(hit), static_cast<float*>(t),
                        static_cast<float*>(d),   static_cast<float*>(esc),
                        static_cast<float*>(nx),  static_cast<float*>(ny),
                        static_cast<float*>(nz),  static_cast<float*>(ao),
                        static_cast<float*>(msteps),
                        static_cast<float*>(work)};
  switch (power) {
#define FR_CASE(P)                                                         \
  case P:                                                                  \
    bulb_march_kernel<P><<<grid_for(width, height), 256, 0, s>>>(         \
        p, tcp, coarse_w, cone, width, height, map_height, shade, out);    \
    break;
    FR_BULB_POWERS(FR_CASE)
#undef FR_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
