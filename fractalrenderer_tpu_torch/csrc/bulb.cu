// K4a, K4b and K4c on Hopper: the Mandelbulb raymarcher's cone prepass, its
// march + shading kernel, and the frame's colour (K4c, further down: the
// hit and sky shading, the AA sum, the post chain and the store).
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
// What bounds it.  Not bytes (4 B of t0 read and 32 B, plus 8 with stats,
// written per pixel) and not the f32 operations (a DE step is 58 on the
// integer-power path at power 8, ~80 with the trig step; ~7e7 steps per
// 1080p frame: ~0.07 ms at the card's FP32 peak).  A frame's time is set
// by how its warps issue the steps: which lanes of a warp step together,
// how often the event code (an orbit's end: logf, division, the march
// update, the next orbit's sqrtf) interrupts them, and the longest chain
// of steps one pixel needs (a grazing ray's march, then its shading),
// which no schedule shortens.  The per-warp counters (trips buffer) read
// this: a first build of the one-loop, one-pixel-per-lane kernel with the
// counters stepped 33-38% of its lanes per step trip, ran events in 33-40%
// of its trips, spent 30-47% of its span in the tail (fewer than half the
// warps running) and issued 45-58% of the card's slots in its time.
//
// Design.  One thread per lane (a coarse cone block for K4a; for K4b a
// pixel's march or one shading orbit), each running its own orbit
// schedule: the TPU kernels' tile loops, DE_CHUNK bursts and cross-lane
// any() exits have nothing to carry over.  The flat form's per-lane
// trajectory is kept exactly, with its exact dr-overflow orbit exit
// (de_finish returns +-0 once dr is +inf, and no consumer tells them
// apart).  K4b is a persistent kernel (one wave of blocks) whose loop trip
// steps every live orbit of a warp once and then runs the events of the
// orbits that ended; a warp vote at every trip keeps the lanes converged
// (without one, nvcc turned the earlier one-loop kernel's step branch into
// an inner loop that ran until the warp's longest orbit ended).  A lane takes its next
// pixel from a queue (one atomicAdd per refill round, 8x4 patches in
// row-major order).  When a march hits, its pixel's 12 shading orbits --
// the full-length esc recovery and the normal's 3 taps, then, once those
// taps are in, the 8 AO taps -- go onto the warp's ring in shared memory
// and run on whichever lanes of the warp are free; the lane that ends the
// pixel's last orbit sums AO in tap order and writes the outputs.  So a
// hit pixel's chain is its march plus two orbits, not twelve, and a lane
// never idles while its warp has work.  The march caps a lane at
// MAX_STEPS evaluations, every one counted (the nested form's bound,
// bulb_kernel.py:681-683).  The power is a template parameter: 2..16 take
// the trig-free integer step, whose square-and-multiply chains unroll at
// compile time in the JAX package's multiplication order into
// straight-line code, and 0 takes the trig step with the runtime power
// (one sincosf per angle: nvcc does not merge sinf and cosf): 16 instances
// of each kernel, every one held against the plain version on the card
// (chip_smoke.py, tests/test_torch_cuda.py).  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_ab.py, kernel records, 1080p shaded frames):
// power 8 3.519 -> 1.786 ms, the trig step 11.242 -> 2.717 ms, power 16
// 4.133 -> 1.484 ms against the one-loop kernel this replaced, every
// plane bit-identical.
//
// Exactness.  Build with -fmad=false and without --use_fast_math: IEEE
// division and sqrtf, subnormals kept, f32 literals equal to
// numpy.float32 of the Python constants, and NaN-propagating max/min/clamp
// as torch.maximum/clamp have.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
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

// A hit's shading taps: the normal's 3, then 8 for AO.
constexpr int kNTaps = 11;

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
struct Camera {
  float f0, f1, f2, r0, r1, r2, u0, u1, u2;
};

__device__ __forceinline__ Camera camera(const float* v) {
  const float rox = v[B_ROX], roy = v[B_ROY], roz = v[B_ROZ];
  const float rlen = sqrtf(rox * rox + roy * roy + roz * roz);
  const float f0 = -rox / rlen, f1 = -roy / rlen, f2 = -roz / rlen;
  const float rx = f2, rz = -f0;
  const float rl = tmax(sqrtf(rx * rx + rz * rz), 1e-12f);
  const float r0 = rx / rl, r1 = 0.0f, r2 = rz / rl;
  return {f0, f1, f2, r0, r1, r2, f1 * r2 - f2 * r1, f2 * r0 - f0 * r2,
          f0 * r1 - f1 * r0};
}

__device__ __forceinline__ Ray pixel_ray(const Camera& c, const float* v,
                                         float px, float py, int width,
                                         int height) {
  const float fov = v[B_FOV];
  const float fh = static_cast<float>(height);
  const float ux = (px - static_cast<float>(width) * 0.5f) / fh;
  const float uy = (py - fh * 0.5f) / fh;
  const float dx = c.f0 + c.r0 * ux * fov + c.u0 * uy * fov;
  const float dy = c.f1 + c.r1 * ux * fov + c.u1 * uy * fov;
  const float dz = c.f2 + c.r2 * ux * fov + c.u2 * uy * fov;
  const float inv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  return {v[B_ROX], v[B_ROY], v[B_ROZ], dx * inv, dy * inv, dz * inv};
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
    // one range reduction per angle (nvcc does not merge sinf and cosf)
    float st, ct, sp, cp;
    sincosf(th, &st, &ct);
    sincosf(ph, &sp, &cp);
    const float nzx = zr * (st * cp) + px;
    const float nzy = zr * (sp * st) + py;
    const float nzz = zr * ct + pz;
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
  const Ray ray = pixel_ray(camera(v), v, pxf, pyf, width, map_height);
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

// K4b's per-warp counters, kTripFields int32 per warp in the optional trips
// buffer (ops/bulb_kernel.py TRIP_FIELDS): loop trips, trips in which a lane
// stepped, trips in which a lane ran event code, the sum over trips of the
// stepping lanes, the pixels the warp finished, its SM, and its start and
// end on the %globaltimer clock (ns; clock64 counts per SM and the SMs'
// counters are not aligned), each a (lo, hi) pair.
enum { T_TRIPS, T_STEP_TRIPS, T_EVENT_TRIPS, T_LANE_STEPS, T_PIXELS, T_SMID,
       T_START_LO, T_START_HI, T_END_LO, T_END_HI };
constexpr int kTripFields = 10;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm volatile("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}
__device__ __forceinline__ int sm_id() {
  int s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

// _flat_shade's closed form for non-hit lanes: parked at (3, 0, 0) with
// d0 = 0, every tap orbit is dead on arrival; nx, ny, nz, ao.
__device__ void dead_lane(float* out) {
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
  const float nx = fb ? zero : nxr / nl;
  const float ny = fb ? one : nyr / nl;
  const float nz = fb ? zero : nzr / nl;
  float ao = 0.0f;
  float k = 0.01f;
  for (int i = 0; i < kNTaps - 3; ++i) {
    ao = ao + expf(-10.0f * dead_de(far + nx * k, zero + ny * k,
                                    zero + nz * k));
    k = k + 0.02f;
  }
  out[0] = nx;
  out[1] = ny;
  out[2] = nz;
  out[3] = ao;
}

// K4b's pixel queue: index i fills 8x4 patches (8 columns, 4 rows), the
// patches in row-major order over pw = ceil(width / 8) patch columns
// (ops/bulb_kernel.py patch_order_xy).
__device__ __forceinline__ void patch_xy(int i, int pw, int& x, int& y) {
  const int q = i >> 5, r = i & 31;
  x = (q % pw) * 8 + (r & 7);
  y = (q / pw) * 4 + (r >> 3);
}

constexpr unsigned kFull = 0xffffffffu;
// A lane whose orbit ended waits until this many lanes of its warp wait,
// or none is live, before the waiting lanes run their event code together.
// 8 and 16 made every instance 11-69% slower on an H100 (PERF.md): the
// waiting lanes idle for more trips than the batched events save.
constexpr int kEventBatch = 1;
// Resident blocks of 256 an SM must hold (4 caps an instance at 64
// registers).  The trig step fits 64 registers without spilling too, but
// ran 5% slower at 4 blocks than at 3 with 72 (PERF.md).
constexpr int min_blocks(int p) { return p == 0 ? 3 : 4; }

// A hit pixel's shading, shared by the lanes of its warp: its 12 orbits
// (the esc recovery and the 11 taps) run on whichever lanes are free.
// Task codes: 0 the esc orbit, 1 + j tap j (0-2 the normal's, 3-10 AO's).
constexpr int kSlots = 32;  // pixels a warp shades at once
constexpr int kRing = 512;  // a warp's queued orbits: <= 12 per slot
constexpr int kIdle = 0, kMarchJob = 1, kTaskJob = 2;

struct Slot {
  float hx, hy, hz, d_hit, t;  // the hit point, its DE and depth
  float n[3];                  // the normal, once taps 0-2 are in
  float d[kNTaps];             // each tap orbit's DE
  int idx, msteps, work;       // pixel, evaluations, its DE steps so far
  int left, left_n;            // orbits outstanding, normal taps too
};
struct WarpShade {
  Slot slot[kSlots];
  unsigned short ring[kRing];  // queued orbits: slot << 4 | task code
  int head, tail;              // orbits taken from / put on the ring
  unsigned free;               // free slots
};

// The start of task `k` of slot `sl`: the hit point for the esc orbit,
// the normal's three basis offsets, then h + n kf with the shader's f32
// loop kf = 0.01, += 0.02.
__device__ __forceinline__ void task_start(const Slot& sl, int k, float& x,
                                           float& y, float& z) {
  x = sl.hx;
  y = sl.hy;
  z = sl.hz;
  if (k == 1) {
    x = sl.hx + 1e-3f;
  } else if (k == 2) {
    y = sl.hy + 1e-3f;
  } else if (k == 3) {
    z = sl.hz + 1e-3f;
  } else if (k > 3) {
    float kf = 0.01f;
    for (int j = 5; j <= k; ++j) kf = kf + 0.02f;
    x = sl.hx + sl.n[0] * kf;
    y = sl.hy + sl.n[1] * kf;
    z = sl.hz + sl.n[2] * kf;
  }
}

// K4b: _make_kernel's flat production path.  A persistent grid (one wave
// of blocks).  A lane marches one pixel at a time, taken from the queue
// (*next, zeroed by the caller) when it is free; a hit pixel's 12 shading
// orbits go to its warp's ring and run on whichever lanes are free, so no
// lane runs a pixel's 12 orbits one after the other.
template <int kP>
__global__ void __launch_bounds__(256, min_blocks(kP))
    bulb_march_kernel(MarchParams p, const float* __restrict__ tc,
                      int coarse_w, int cone, int width, int height,
                      int map_height, int shade, MarchOut out,
                      int* __restrict__ next, int* __restrict__ trips) {
  const float* v = p.v;
  const unsigned lane = threadIdx.x & 31;
  int* const wt = trips == nullptr ? nullptr
                                   : trips + ((blockIdx.x << 3) +
                                              (threadIdx.x >> 5)) *
                                                 kTripFields;
  if (wt != nullptr && lane == 0) {
    const unsigned long long t0 = global_ns();
    wt[T_SMID] = sm_id();
    wt[T_START_LO] = static_cast<int>(t0);
    wt[T_START_HI] = static_cast<int>(t0 >> 32);
  }
  // launch constants (the camera basis, the non-hit lanes' shading) and
  // each warp's shading slots and ring
  __shared__ Camera cam;
  __shared__ float dead[4];
  __shared__ WarpShade shades[8];
  WarpShade& ws = shades[threadIdx.x >> 5];
  if (threadIdx.x == 0) {
    cam = camera(v);
    if (shade) dead_lane(dead);
  }
  if (lane == 0) {
    ws.head = ws.tail = 0;
    ws.free = kFull;
  }
  __syncthreads();

  const int row0 = static_cast<int>(v[B_ROW0]);
  const float power = v[B_POWER];
  const int limit = static_cast<int>(v[B_LIMIT]);
  const int pw = (width + 7) >> 3;
  const int npix = pw * ((height + 3) >> 2) * 32;
  const int frac = tc != nullptr ? row0 % cone : 0;  // row0 - floor(..)*cone
  const int n_tasks = shade ? 1 + kNTaps : 1;

  // the lane's job: a pixel's march (its index and ray, _flat_march's
  // state) or one shading orbit (task = slot << 4 | code), and its orbit;
  // work counts the job's DE steps
  int job = kIdle, task = 0, idx = 0;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f, t = 0.0f;
  int mstep = 0, work = 0;
  bool hit = false, relax = true, rel_prev = false;
  float d_hit = 0.0f, prev_step = 0.0f, prev_rad = kInf;
  Orbit o;
  o.start(0.0f, 0.0f, 4.0f);  // dead until the lane's first job

  bool need = true;    // the lane wants a job
  bool hitq = false;   // the lane's march hit: its pixel wants a slot
  bool open = true;    // the pixel queue has pixels left
  unsigned c_trips = 0, c_step = 0, c_event = 0, c_lanes = 0, c_pix = 0;
  for (;;) {
    __syncwarp();
    // 1. a slot for each pixel whose march hit (one is free: new pixels
    // are handed out only while the free slots outnumber the marches)
    const unsigned hm = __ballot_sync(kFull, hitq);
    if (hm != 0u) {
      const unsigned fr = ws.free;
      const int tail = ws.tail;
      int s = 0;
      if (hitq) {
        const int r = __popc(hm & lanes_below());
        unsigned m = fr;
        for (int j = 0; j < r; ++j) m &= m - 1u;
        s = __ffs(m) - 1;
        Slot& sl = ws.slot[s];
        sl.hx = v[B_ROX] + dx * t;
        sl.hy = v[B_ROY] + dy * t;
        sl.hz = v[B_ROZ] + dz * t;
        sl.d_hit = d_hit;
        sl.t = t;
        sl.idx = idx;
        sl.msteps = mstep;
        sl.work = work;
        sl.left = n_tasks;
        sl.left_n = 3;
        // its esc orbit and, with shade, the normal's three taps
        const int nq = shade ? 4 : 1;
        for (int j = 0; j < nq; ++j)
          ws.ring[(tail + r * nq + j) & (kRing - 1)] =
              static_cast<unsigned short>(s << 4 | j);
        hitq = false;
      }
      const unsigned took = __reduce_or_sync(kFull, hm >> lane & 1u ? 1u << s
                                                                    : 0u);
      __syncwarp();
      if (lane == 0) {
        ws.free = fr & ~took;
        ws.tail = tail + __popc(hm) * (shade ? 4 : 1);
      }
      __syncwarp();
    }

    // 2. jobs for the lanes that want one: queued orbits first
    unsigned needm = __ballot_sync(kFull, need);
    if (needm != 0u) {
      const int head = ws.head;
      const int nt = min(__popc(needm), ws.tail - head);
      if (nt > 0) {
        const int r = __popc(needm & lanes_below());
        if (need && r < nt) {
          task = ws.ring[(head + r) & (kRing - 1)];
          float x, y, z;
          task_start(ws.slot[task >> 4], task & 15, x, y, z);
          o.start(x, y, z);
          job = kTaskJob;
          work = 0;
          need = false;
        }
        __syncwarp();
        if (lane == 0) ws.head = head + nt;
        needm = __ballot_sync(kFull, need);
      }
    }
    // then new pixels, while a slot stays free for every march; a padding
    // pixel of the ragged edges takes another round
    if (needm != 0u && open) {
      const int room = __popc(ws.free) -
                       __popc(__ballot_sync(kFull, job == kMarchJob));
      unsigned elig = needm;
      for (int j = __popc(needm); j > room; --j)
        elig &= ~(1u << (31 - __clz(elig)));  // keep the lowest `room`
      while (elig != 0u && open) {
        const int leader = __ffs(elig) - 1;
        int base = 0;
        if (static_cast<int>(lane) == leader)
          base = atomicAdd(next, __popc(elig));
        base = __shfl_sync(kFull, base, leader);
        const bool mine = elig >> lane & 1u;
        const int i = base + __popc(elig & lanes_below());
        open = !__any_sync(kFull, mine && i >= npix);
        int col = 0, lrow = 0;
        if (mine && i < npix) patch_xy(i, pw, col, lrow);
        const bool got = mine && i < npix && col < width && lrow < height;
        elig &= ~__ballot_sync(kFull, got || (mine && i >= npix));
        if (!got) continue;
        need = false;
        job = kMarchJob;
        idx = lrow * width + col;
        const Ray ray =
            pixel_ray(cam, v, static_cast<float>(col) + v[B_OFFX],
                      static_cast<float>(lrow + row0) + v[B_OFFY], width,
                      map_height);
        dx = ray.dx;
        dy = ray.dy;
        dz = ray.dz;
        // start depth: the cone prepass's t of the pixel's block
        t = 0.001f;
        if (tc != nullptr)
          t = tmax(__ldg(tc + static_cast<size_t>((frac + lrow) / cone) *
                                  coarse_w + col / cone),
                   0.001f);
        mstep = work = 0;
        hit = rel_prev = false;
        relax = true;
        d_hit = prev_step = 0.0f;
        prev_rad = kInf;
        o.start(v[B_ROX] + dx * t, v[B_ROY] + dy * t, v[B_ROZ] + dz * t);
      }
    }
    // every lane is free, nothing is queued and the pixels are all out
    if (__ballot_sync(kFull, job != kIdle) == 0u) break;

    // 3. one DE step on every live orbit
    const bool esc_orbit = job == kTaskJob && (task & 15) == 0;
    const bool lv = job != kIdle && o.live(limit, esc_orbit);
    const unsigned stepm = __ballot_sync(kFull, lv);
    if (lv) {
      o.step<kP>(limit, power);
      ++work;
    }
    // the lanes whose orbit has ended wait for their event
    const bool wait = job != kIdle && !o.live(limit, esc_orbit);
    const unsigned waitm = __ballot_sync(kFull, wait);
    const unsigned actm = __ballot_sync(kFull, job != kIdle);
    const bool run =
        waitm != 0u && (waitm == actm || __popc(waitm) >= kEventBatch);
    ++c_trips;
    c_step += stepm != 0u;
    c_lanes += __popc(stepm);
    c_event += run;
    if (!run || !wait) continue;

    // 4. the events: the orbit's DE, then its job's update
    const float d = de_finish(o.r, o.dr);
    const bool was_task = job == kTaskJob;
    if (job == kMarchJob) {
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
      if (!ended && mstep < kMaxSteps) {
        o.start(v[B_ROX] + dx * t, v[B_ROY] + dy * t, v[B_ROZ] + dz * t);
      } else {
        job = kIdle;
        need = true;
        hitq = hit;  // a hit's shading takes a slot at the next trip
        if (!hit) {
          // a miss: its outputs, with _flat_shade's closed form
          out.hit[idx] = 0.0f;
          out.t[idx] = t;
          out.d[idx] = 0.0f;
          out.esc[idx] = 0.0f;
          if (shade) {
            out.nx[idx] = dead[0];
            out.ny[idx] = dead[1];
            out.nz[idx] = dead[2];
            out.ao[idx] = dead[3];
          }
          if (out.msteps != nullptr) {
            out.msteps[idx] = static_cast<float>(mstep);
            out.work[idx] = static_cast<float>(work);
          }
          ++c_pix;
        }
      }
    } else {
      // a shading orbit: the esc index (_de_tile's) or the tap's DE
      Slot& sl = ws.slot[task >> 4];
      const int k = task & 15;
      if (k == 0) {
        out.esc[sl.idx] = o.esc < 0 ? static_cast<float>(limit)
                                    : static_cast<float>(o.esc);
      } else {
        sl.d[k - 1] = d;
      }
      atomicAdd(&sl.work, work);
      job = kIdle;
      need = true;
    }
    // a finished orbit's slot: the normal once its three taps are in (and
    // the AO taps onto the ring), the outputs once all 12 orbits are
    __syncwarp(waitm);
    if (!was_task) continue;
    const int s = task >> 4, k = task & 15;
    Slot& sl = ws.slot[s];
    if (k >= 1 && k <= 3 && atomicSub(&sl.left_n, 1) == 1) {
      // the normal by forward differences (d0 = d_hit)
      const float nxr = sl.d[0] - sl.d_hit, nyr = sl.d[1] - sl.d_hit,
                  nzr = sl.d[2] - sl.d_hit;
      float nl = sqrtf(nxr * nxr + nyr * nyr + nzr * nzr);
      const bool fb = nl < 1e-4f;
      nl = tmax(nl, 1e-12f);
      sl.n[0] = fb ? 0.0f : nxr / nl;
      sl.n[1] = fb ? 1.0f : nyr / nl;
      sl.n[2] = fb ? 0.0f : nzr / nl;
      const int q = atomicAdd(&ws.tail, kNTaps - 3);
      for (int j = 0; j < kNTaps - 3; ++j)
        ws.ring[(q + j) & (kRing - 1)] =
            static_cast<unsigned short>(s << 4 | (4 + j));
    }
    if (atomicSub(&sl.left, 1) != 1) continue;
    // the pixel's last orbit: its outputs (esc is in), the slot freed
    const int px = sl.idx;
    out.hit[px] = 1.0f;
    out.t[px] = sl.t;
    out.d[px] = sl.d_hit;
    if (shade) {
      float ao = 0.0f;
      for (int j = 3; j < kNTaps; ++j) ao = ao + expf(-10.0f * sl.d[j]);
      out.nx[px] = sl.n[0];
      out.ny[px] = sl.n[1];
      out.nz[px] = sl.n[2];
      out.ao[px] = ao;
    }
    if (out.msteps != nullptr) {
      out.msteps[px] = static_cast<float>(sl.msteps);
      out.work[px] = static_cast<float>(sl.work);
    }
    atomicOr(&ws.free, 1u << s);
    ++c_pix;
  }

  const int pix = __reduce_add_sync(kFull, c_pix);
  if (wt != nullptr && lane == 0) {
    const unsigned long long t1 = global_ns();
    wt[T_TRIPS] = static_cast<int>(c_trips);
    wt[T_STEP_TRIPS] = static_cast<int>(c_step);
    wt[T_EVENT_TRIPS] = static_cast<int>(c_event);
    wt[T_LANE_STEPS] = static_cast<int>(c_lanes);
    wt[T_PIXELS] = pix;
    wt[T_END_LO] = static_cast<int>(t1);
    wt[T_END_HI] = static_cast<int>(t1 >> 32);
  }
}

dim3 grid_for(int w, int h) { return dim3((w + 31) / 32, (h + 7) / 8); }

// The power's instance: 0 (trig step) or 2..16 (integer step).
#define FR_BULB_POWERS(X) \
  X(0) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)

// K4b's resident blocks of 256 per SM for instance `power` and the SM
// count of the current device, each asked once per device and cached.
int march_residency(int power, int* per_sm, int* sms) {
  constexpr int kDevices = 64;
  static int cache_per_sm[kDevices][17], cache_sms[kDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev >= kDevices || power < 0 || power > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cache_per_sm[dev][power] == 0) {
    int n = 0;
    switch (power) {
#define FR_CASE(P)                                                    \
  case P:                                                             \
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
        &n, bulb_march_kernel<P>, 256, 0);                           \
    break;
      FR_BULB_POWERS(FR_CASE)
#undef FR_CASE
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (n < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    rc = cudaDeviceGetAttribute(&cache_sms[dev],
                                cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    cache_per_sm[dev][power] = n;
  }
  *per_sm = cache_per_sm[dev][power];
  *sms = cache_sms[dev];
  return 0;
}

// K4b's grid: one wave (SMs x resident blocks), or fewer blocks where the
// field's pixel queue has fewer than that many 256-lane blocks.
int march_blocks(int power, int width, int height, int* blocks,
                 int* per_sm) {
  int sms = 0;
  const int rc = march_residency(power, per_sm, &sms);
  if (rc != 0) return rc;
  const long long queue =
      static_cast<long long>((width + 7) / 8) * ((height + 3) / 4) * 32;
  *blocks = static_cast<int>(
      std::min<long long>(static_cast<long long>(sms) * *per_sm,
                          (queue + 255) / 256));
  return 0;
}

// ---------------------------------------------------------------------------
// K4c: one AA sample of a bulb band's shading, then, on the frame's last
// sample, its AA sum, post chain and store.
//
// Replaces no TPU kernel: the JAX package leaves this shading to XLA
// (fractalrenderer_tpu/models/mandelbulb.py _render_sample, shade_hit and
// sky_color at :189-237).  The plain version is
// fractalrenderer_tpu_torch/ops/bulb_shade.py:shade_fields_plain, the torch
// glue the port ran after K4b before this kernel; the two agree bit for bit.
//
// What bounds it: bytes.  A pixel reads K4b's 8 f32 planes (32 B) and,
// after the first sample, the f32 accumulator (12 B), and writes 3 B
// (uint8), 6 B (uint16) or 12 B (f32, or the accumulator); its ~30
// math-library calls and ~350 other f32 operations are ~0.01 ms of a 1080p
// frame at the FP32 peak.  One thread per pixel keeps every intermediate
// in registers, where the glue it replaces wrote and read f32 planes.
//
// Exactness: each expression in the plain code's order, as PyTorch's CUDA
// kernels evaluate it one operation at a time: a Python float meets the f32
// image as static_cast<float> of the same double (f32c below), a tensor
// divisor divides exactly, pow with a scalar exponent takes PyTorch's own
// special cases (2 is x * x, 0.5 is sqrtf, any other powf), sinf, expf,
// logf, floorf, fmodf and powf are the calls PyTorch's kernels make, and
// max/min/clamp keep a NaN as torch.maximum/minimum/clamp do.  0-dim
// values the glue computes on the card (the log of the dynamic power, the
// palette mix) are computed here in f32 the same way.

// A Python float as PyTorch's CUDA kernels take it: rounded to f32 once.
__host__ __device__ constexpr float f32c(double x) {
  return static_cast<float>(x);
}

// ops/bulb_shade.py S_*: the march vector's camera slots first (camera()
// and pixel_ray() read them as K4b does), then the dynamic power, the
// colour scalars, the iteration limit and the sample's offset.
enum { S_ROX, S_ROY, S_ROZ, S_FOV, S_POWER, S_TIME, S_COFF, S_CSCALE,
       S_BRIGHT, S_SAT, S_CONTRAST, S_MAXIT, S_OFFX, S_OFFY };
constexpr int kNS = 14;
static_assert(static_cast<int>(S_ROX) == B_ROX &&
                  static_cast<int>(S_ROY) == B_ROY &&
                  static_cast<int>(S_ROZ) == B_ROZ &&
                  static_cast<int>(S_FOV) == B_FOV,
              "pixel_ray reads the camera from the march vector's slots");

struct ShadeParams {
  float v[kNS];
  int width, rows, row0, map_height, aa, first, last;
};
struct ShadeIn {
  const float *hit, *t, *d, *esc, *nx, *ny, *nz, *ao;
};

// bulb_math.shade_hit's light direction: math.sqrt(1.0 + 1.0 + 0.8 * 0.8)
// and its quotients, in double as Python folds them.
constexpr double kLl = 1.624807680927192;
constexpr double kLx = 1.0 / kLl, kLz = 0.8 / kLl;

__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
// palettes._clamp: torch.maximum, then torch.minimum.
__device__ __forceinline__ float pclamp(float t, float lo, float hi) {
  return tmin(tmax(t, lo), hi);
}
__device__ __forceinline__ float fract(float t) { return t - floorf(t); }
// torch.remainder on f32 (PyTorch's CUDA kernel: fmod, moved to the
// divisor's sign).
__device__ __forceinline__ float tremainder(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod += b;
  return mod;
}

// palettes._bulb_hsv2rgb.
__device__ __forceinline__ void bulb_hsv2rgb(float h, float s, float val,
                                             float* c) {
  const float shift[3] = {0.0f, 4.0f, 2.0f};
  const float rest = 1.0f * (1.0f - s);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float rgb = pclamp(
        fabsf(tremainder(h * 6.0f + shift[k], 6.0f) - 3.0f) - 1.0f, 0.0f,
        1.0f);
    c[k] = val * (rest + rgb * s);
  }
}

// palettes._hash and _noise.
__device__ __forceinline__ float bulb_hash(float px, float py) {
  return fract(sinf(px * f32c(127.1) + py * f32c(311.7)) *
               f32c(43758.5453123));
}
__device__ __forceinline__ float bulb_noise(float px, float py) {
  const float ix = floorf(px), iy = floorf(py);
  const float fx = px - ix, fy = py - iy;
  const float a = bulb_hash(ix, iy);
  const float b = bulb_hash(ix + 1.0f, iy);
  const float c = bulb_hash(ix, iy + 1.0f);
  const float d = bulb_hash(ix + 1.0f, iy + 1.0f);
  const float ux = fx * fx * (3.0f - 2.0f * fx);
  const float uy = fy * fy * (3.0f - 2.0f * fy);
  return (a * (1.0f - ux) + b * ux) + (c - a) * uy * (1.0f - ux) +
         (d - b) * ux * uy;
}

// palettes.bulb_dynamic, bulb_fire_and_ice, bulb_lava, bulb_neon.
__device__ __forceinline__ void bulb_dynamic(float t, float* c) {
  const float hue = fract(t + f32c(0.3) * sinf(t * 12.0f));
  const float sat = f32c(0.6) + f32c(0.4) * sinf(t * 7.0f);
  bulb_hsv2rgb(hue, sat, powf(t, f32c(0.4)), c);
}
__device__ __forceinline__ void bulb_fire_and_ice(float t, float* c) {
  const float tc = pclamp(t, 0.0f, 1.0f);
  const float blend = tc * tc * (3.0f - 2.0f * tc);
  const float f = fract(t * 3.0f);
  const float rest = 1.0f - f;
  // fire (blend^2, blend/2, 0) and ice (0, 0.5 + blend/2, 1), each times
  // 1.0 (exact), mixed by f
  c[0] = (blend * blend) * rest + 0.0f * f;
  c[1] = (blend * 0.5f) * rest + (0.5f + 0.5f * blend) * f;
  c[2] = 0.0f * rest + 1.0f * f;
}
__device__ __forceinline__ void bulb_lava(float t, float* c) {
  const float cols[5][3] = {{f32c(0.1), 0.0f, 0.0f},
                            {f32c(0.8), f32c(0.1), 0.0f},
                            {1.0f, 0.5f, 0.0f},
                            {1.0f, f32c(0.9), f32c(0.3)},
                            {1.0f, 1.0f, f32c(0.8)}};
  const float bounds[5] = {0.0f, 0.25f, 0.5f, 0.75f, 1.0f};
  // palettes._piecewise5_planar: the first segment with t < its upper
  // bound, else the last stop (a NaN too)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (t < bounds[i + 1]) {
      const float f = (t - bounds[i]) / f32c(0.25);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        c[k] = (1.0f - f) * cols[i][k] + f * cols[i + 1][k];
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = cols[4][k];
}
__device__ __forceinline__ void bulb_neon(float t, float* c) {
  const float a[3] = {0.0f, 0.0f, f32c(0.1)}, b[3] = {0.0f, f32c(0.2),
                                                       f32c(0.6)};
  const float e[3] = {0.0f, f32c(0.8), 1.0f}, g[3] = {0.5f, 1.0f, 1.0f};
  const float t2 = t * t;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = a[k] * (1.0f - t) + b[k] * t;
    const float hi = e[k] * (1.0f - t) + g[k] * t;
    c[k] = lo * (1.0f - t2) + hi * t2;
  }
}

// palettes.bulb_color: fract, the hash noise, the mode's palette (the mode
// is the launch's, so the branch is uniform).
__device__ __forceinline__ void bulb_color(float t, int mode, float* c) {
  t = fract(t);
  const float n = bulb_noise(t * 100.0f, t * 57.0f) * f32c(0.02);
  switch (mode) {
    case 1:
      bulb_fire_and_ice(t + n, c);
      break;
    case 2:
      bulb_lava(t + n, c);
      break;
    case 3:
      bulb_neon(t + n, c);
      break;
    case 4:
      bulb_dynamic(sqrtf(t) + n, c);
      break;
    case 5:
      bulb_fire_and_ice(powf(t, f32c(0.6)) + n, c);
      break;
    default:
      bulb_dynamic(t + n, c);
  }
}

// bulb_math.shade_hit at a hit pixel: the ray, K4b's planes there, log(dyn
// power + 1e-4) and the palette mix weight.
__device__ __forceinline__ void shade_hit(const float* v, const Ray& ray,
                                          float t, float d, float esc,
                                          float nx, float ny, float nz,
                                          float ao_sum, float log_power,
                                          float mixw, int mode, float* c) {
  const float lx = f32c(kLx), ly = f32c(kLx), lz = f32c(kLz);
  const float diffuse = tmax(nx * lx + ny * ly + nz * lz, 0.0f);
  const float vx = -ray.dx, vy = -ray.dy, vz = -ray.dz;
  const float ndl = nx * lx + ny * ly + nz * lz;
  const float rx = -lx + 2.0f * ndl * nx;
  const float ry = -ly + 2.0f * ndl * ny;
  const float rz = -lz + 2.0f * ndl * nz;
  const float spec = powf(tmax(vx * rx + vy * ry + vz * rz, 0.0f), 64.0f);
  const float rim_b = 1.0f - tmax(nx * vx + ny * vy + nz * vz, 0.0f);
  const float rim = rim_b * rim_b;
  const float glow = expf(-8.0f * d);
  const float filament = expf(-30.0f * d);

  const float px = v[S_ROX] + ray.dx * t, py = v[S_ROY] + ray.dy * t,
              pz = v[S_ROZ] + ray.dz * t;
  const float pr = sqrtf(px * px + py * py + pz * pz);
  const float log_pr = logf(tmax(pr, f32c(1e-12)));
  float it = esc + 1.0f - logf(tmax(log_pr, f32c(1e-12))) / log_power;
  it = it / v[S_MAXIT];
  it = fract(v[S_COFF] + powf(tmax(it, 0.0f), f32c(0.6)) * v[S_CSCALE]);
  float base[3], alt[3];
  bulb_color(it, mode, base);
  bulb_color(fract(it + f32c(0.33)), (mode + 1) % 6, alt);
  const float keep = 1.0f - mixw;
  const float shade = f32c(0.15) + diffuse * f32c(0.9);
  const float fil[3] = {1.0f, f32c(0.8), 0.5f};
  const float fog_col[3] = {0.0f, 0.0f, f32c(0.1)};
  const float ao = 1.0f - ao_sum / 8.0f;
  const float fog = tclamp(t / kMaxDist, 0.0f, 1.0f) * f32c(0.6);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float x = base[k] * keep + alt[k] * mixw;
    x = x * shade;
    x = x + spec * 0.5f;
    x = x + rim * 0.25f;
    x = x + glow * 0.5f;
    x = x + fil[k] * filament * 0.5f;
    x = x * (ao * f32c(0.8) + f32c(0.2));
    c[k] = x * (1.0f - fog) + fog_col[k] * fog;
  }
}

// coloring.enhance_color, aces_tonemap and gamma_correct on one pixel.
__device__ __forceinline__ void post_chain(const float* v, float* c) {
  const float br = v[S_BRIGHT], sat = v[S_SAT], con = v[S_CONTRAST];
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = (c[k] * br - 0.5f) * con + 0.5f;
  const float gray = c[0] * f32c(0.299) + c[1] * f32c(0.587) +
                     c[2] * f32c(0.114);
  const float rest = 1.0f - sat;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float x = tclamp(gray * rest + c[k] * sat, 0.0f, 1.0f);
    const float y = tclamp((x * (f32c(2.51) * x + f32c(0.03))) /
                               (x * (f32c(2.43) * x + f32c(0.59)) +
                                f32c(0.14)),
                           0.0f, 1.0f);
    c[k] = powf(tmax(y, 0.0f), f32c(1.0 / 2.2));
  }
}

// coloring.quantize_image on one value (csrc/escape.cu quantize8/16):
// torch.clamp(x, 0, 1), an f32 multiply, a separate f32 add of 0.5, then
// the cast of PyTorch's CUDA copy_ (through int64 for uint8).
__device__ __forceinline__ uint8_t quantize8(float x) {
  const float v = tclamp(x, 0.0f, 1.0f) * 255.0f + 0.5f;
  return static_cast<uint8_t>(static_cast<int64_t>(v));
}
__device__ __forceinline__ uint16_t quantize16(float x) {
  const float v = tclamp(x, 0.0f, 1.0f) * 65535.0f + 0.5f;
  return static_cast<uint16_t>(v);
}

// K4c.  One thread per pixel of the band (rows x width, row-major): the
// glue's ray grid (x + ox, (y + oy) + row0) through pixel_ray, the hit or
// sky colour, the select on hit > 0.5, then acc = acc + colour (from zero
// on the first sample) into `acc` (rows, width, 3) f32 unless this is the
// last sample; on the last, acc / aa^2, the post chain and the store into
// `out` (rows, width, 3) as f32 (store 0), uint8 (8) or uint16 (16).
__global__ void __launch_bounds__(256)
    bulb_shade_kernel(ShadeParams p, int mode, int store, ShadeIn in,
                      float* acc, void* out) {
  const float* v = p.v;
  __shared__ Camera cam;
  if (threadIdx.x == 0) cam = camera(v);
  __syncthreads();
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= p.width * p.rows) return;
  const int x = i % p.width, y = i / p.width;
  const float px = static_cast<float>(x) + v[S_OFFX];
  const float py = (static_cast<float>(y) + v[S_OFFY]) +
                   static_cast<float>(p.row0);
  const Ray ray = pixel_ray(cam, v, px, py, p.width, p.map_height);

  float c[3];
  if (in.hit[i] > 0.5f) {
    const float log_power = logf(v[S_POWER] + f32c(1e-4));
    const float mixw = f32c(0.3) + f32c(0.3) * sinf(v[S_TIME] * 0.5f);
    shade_hit(v, ray, in.t[i], in.d[i], in.esc[i], in.nx[i], in.ny[i],
              in.nz[i], in.ao[i], log_power, mixw, mode, c);
  } else {
    // bulb_math.sky_color
    const float sky = tclamp(ray.dy * 0.5f + 0.5f, 0.0f, 1.0f);
    const float rest = 1.0f - sky;
    c[0] = f32c(0.02) * rest + 0.5f * sky;
    c[1] = f32c(0.02) * rest + f32c(0.6) * sky;
    c[2] = f32c(0.05) * rest + f32c(0.8) * sky;
  }
  const size_t o = static_cast<size_t>(i) * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = (p.first ? 0.0f : acc[o + k]) + c[k];
  if (!p.last) {
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[o + k] = c[k];
    return;
  }
  const float n = static_cast<float>(p.aa * p.aa);
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = c[k] / n;
  post_chain(v, c);
  if (store == 8) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      static_cast<uint8_t*>(out)[o + k] = quantize8(c[k]);
  } else if (store == 16) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      static_cast<uint16_t*>(out)[o + k] = quantize16(c[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) static_cast<float*>(out)[o + k] = c[k];
  }
}

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
// `next` one int32 on the device, zero, the pixel queue's head; writes
// hit, t, d, esc and, with `shade`, nx, ny, nz, ao, and, where `msteps`
// is not null, msteps and work, each (height, width) f32; where `trips`
// is not null, the per-warp counters (kTripFields int32 for each of the
// launch's warps, fr_bulb_march_grid).
int fr_bulb_march(int power, const float* params, const void* tc,
                  int coarse_w, int cone, int width, int height,
                  int map_height, int shade, void* hit, void* t, void* d,
                  void* esc, void* nx, void* ny, void* nz, void* ao,
                  void* msteps, void* work, void* next, void* trips,
                  void* stream) {
  MarchParams p;
  std::memcpy(p.v, params, sizeof(p.v));
  int blocks = 0, per_sm = 0;
  const int rc = march_blocks(power, width, height, &blocks, &per_sm);
  if (rc != 0) return rc;
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
    bulb_march_kernel<P><<<blocks, 256, 0, s>>>(                           \
        p, tcp, coarse_w, cone, width, height, map_height, shade, out,     \
        static_cast<int*>(next), static_cast<int*>(trips));                \
    break;
    FR_BULB_POWERS(FR_CASE)
#undef FR_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4b's launch shape for a width x height field on the current device:
// the blocks of 256 threads it launches (its warps, 8 a block, are the
// rows of the trips buffer) and the instance's resident blocks per SM.
int fr_bulb_march_grid(int power, int width, int height, int* blocks,
                       int* blocks_per_sm) {
  return march_blocks(power, width, height, blocks, blocks_per_sm);
}

// Launch K4c on `stream` for one AA sample of a rows x width band from
// global row `row0` of a `map_height`-row image: `params` is the 14-float
// shade vector (ops/bulb_shade.py S_*, copied into the by-value argument);
// `mode` the palette (0..5); hit ... ao K4b's (rows, width) f32 planes.
// Unless `first`, adds the sample to `acc` ((rows, width, 3) f32); unless
// `last`, writes the sum there; on the last sample writes the finished
// band to `out` ((rows, width, 3): f32 for store 0, uint8 for 8, uint16
// for 16).  Returns the cudaError_t of the launch.
int fr_bulb_shade(const float* params, int width, int rows, int row0,
                  int map_height, int aa, int first, int last, int mode,
                  int store, const void* hit, const void* t, const void* d,
                  const void* esc, const void* nx, const void* ny,
                  const void* nz, const void* ao, void* acc, void* out,
                  void* stream) {
  if ((store != 0 && store != 8 && store != 16) || mode < 0 || mode > 5 ||
      width < 1 || rows < 1 || aa < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ShadeParams p;
  std::memcpy(p.v, params, sizeof(p.v));
  p.width = width;
  p.rows = rows;
  p.row0 = row0;
  p.map_height = map_height;
  p.aa = aa;
  p.first = first;
  p.last = last;
  const ShadeIn in = {
      static_cast<const float*>(hit), static_cast<const float*>(t),
      static_cast<const float*>(d),   static_cast<const float*>(esc),
      static_cast<const float*>(nx),  static_cast<const float*>(ny),
      static_cast<const float*>(nz),  static_cast<const float*>(ao)};
  const long long n = static_cast<long long>(width) * rows;
  bulb_shade_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      p, mode, store, in, static_cast<float*>(acc), out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
