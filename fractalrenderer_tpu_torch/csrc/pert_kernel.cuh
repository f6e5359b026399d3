// K3 on Hopper: the perturbation deep-zoom kernel, shared by the four
// families' translation units (csrc/perturbation.cu: Mandelbrot and the
// entry point; csrc/pert_julia.cu, pert_ship.cu, pert_phoenix.cu), each of
// which instantiates its three delta tiers: f32, double-double and floatexp
// (dd mantissa + i32 exponent, csrc/floatexp.cuh).
//
// Replaces fractalrenderer_tpu/ops/perturbation.py:_make_kernel in its
// three launched forms, a template parameter here:
//   kRebase  in-kernel-rounds rebasing (``rebase=True, inkernel_rounds >
//            0``), every family and tier;
//   kLedger  the same with the Burning Ship dd / floatexp error ledger
//            (``track_err``, :302-310, :605-629, :902-920, :1039-1065);
//   kSingle  the single-pass non-rebasing form of ``_pert_call`` (:1349),
//            Mandelbrot only: the Pauldelbrot flag :1139-1147, starved
//            lanes :1222-1230 and the f32 float continuation :1232-1263.
// Mapping and stacked AA :402-467, series / Julia initialisation :488-636,
// f32 update :1070-1136, dd update :926-1069, floatexp updates :680-925,
// outputs :1265-1284.  The plain PyTorch version is
// fractalrenderer_tpu_torch/ops/perturbation.py:perturbation_fields_plain;
// the two agree bit for bit on every plane they write.
//
// Design.  One thread per pixel in 32x8 blocks, grid.z = the spp^2 stacked
// AA segments (1 without AA): a block never straddles segments, so the TPU
// kernel's segment padding has no counterpart.  The 41 scalar parameters
// arrive by value, the reference orbit as one table in global memory, read
// through the read-only cache: per entry 2 (f32 tier), 4 (dd and floatexp:
// hi and lo of the f64 orbit) or 8 floats (Julia floatexp: hi, lo and
// exponent of the drift D = Z - Z0, padded), which the wrapper interleaves
// from the plain version's streams.  Family and tier are template
// parameters (12 instances).
// Each lane iterates its delta against the orbit
//     Mandelbrot  d <- 2 Z d + d^2 + dc
//     Julia       d <- 2 Z d + d^2, Z = Z0 + D        (no dc term)
//     Ship        d <- diffabs recurrence + dc
//     Phoenix     d <- 2 Z d + d^2 + dc + p d + r d_prev
// until it escapes, its budget runs out, or its full value drops below |d|
// (or it reaches the orbit's end): then it rebases (d <- Z_{i+1} + d; Julia
// d <- D_{i+1} + d; Phoenix d_prev <- Z_i + d_i) and at once restarts at
// orbit index 0 with z, nf and its state carried over, up to max_passes
// rounds.  The TPU kernel runs the rounds per tile; a lane's iteration
// sequence is the same either way, and the rounds plane here is per pixel
// (its max equals the TPU's passes).  A lane still wanting after max_passes
// rounds leaves with want = 1 for the host's HP fallback.
//
// The ledger (kLedger) keeps a log2 bound errx of the carried delta's
// absolute error: errx <- max(errx + log2|2z|, log2|d'| - 48) each step,
// carried through rebases.  The single pass (kSingle) never rebases: a lane
// runs to min(limit, orbit end), is flagged (glitch) where |z|^2 falls
// below glitch_tol |Z|^2, and a lane alive at the orbit's end is flagged
// too, or with float continuation iterates z <- z^2 + c on in f32.  The
// TPU kernel moves its tile's shared orbit index in whole chunks of 16, so
// a continuing lane resumes at n0 + 16 ceil((end - n0) / 16), not at the
// orbit's end; the port follows that (kChunk).
//
// Each lane carries the orbit entry Z_i in registers: a step loads Z_{i+1}
// only, in one vector load (two in the Julia floatexp tier) at one index
// product, and Z_{i+1}, which the rebase test reads anyway, is the next
// step's Z_i.  Z_i is loaded again only where the lane's index jumps: at n0
// and at index 0 after a rebase restart.
//
// What bounds it.  The FP32 pipe's issue rate: per step ~30-40 operations
// in the f32 tier, ~170-250 in the dd tier (five to eleven dd products)
// and ~190-330 in the floatexp tier (the Julia and Ship floatexp steps
// renormalise after every operation; chip_smoke.py OPS_PER_ITER), times
// the pixel's iteration count, plus loads, selects and loop control, and
// divergence between the lanes of a warp.  The TPU kernel built each dd
// product from a Dekker two_prod (two Veltkamp splits and four partial
// products, ~16 instructions: its VPU has no f32 FMA); here two_prod is
// one exact fmaf (csrc/dd.cuh), so a dd_mul is 9 instructions and a
// dd_mul_float 7.  The orbit (<= 32 B per entry) stays in L2; warps read
// it at one index until their lanes' first rebases, after which each lane
// reads its own index.  Memory written: 20 B per pixel.
//
// Not done here, and why.  Staging the orbit in shared memory: config 4's
// orbit is 10 000 x 16 B = 160 KB, while a warp is in step its reads are
// broadcast L1 hits, and staging would cost occupancy on a latency-bound
// dd chain.  Lane refill or persistent blocks: the warp-max waste is ~1.12
// on config 4.  Tensor cores, TMA and wgmma: the work is scalar dd
// arithmetic per pixel, and no exact f32 product runs on the tensor cores.
//
// Exactness.  Build with -fmad=false (csrc/dd.cuh); the iteration counter
// is an f32 compared against the f32 limit; offsets of stacked segments are
// exact dyadic quotients, so a segment maps bit-identically to a sequential
// render at its offset.

#ifndef FR_PERT_KERNEL_CUH_
#define FR_PERT_KERNEL_CUH_

#include <cuda_runtime.h>

#include "dd.cuh"
#include "floatexp.cuh"

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

// The reference orbit as one interleaved table (orbit_width floats per
// entry, 16-byte aligned), geometry, the single pass's float continuation
// switch and the output planes (a form leaves the planes it does not write
// untouched: want and rounds belong to the rebasing forms, glitch to the
// single pass, errx to the ledger).
struct PertArgs {
  const float* orbit;
  int width, height, map_height, max_passes, spp, float_cont;
  int* n;
  float *zx, *zy, *glitch, *want, *rounds, *errx;
};

constexpr int kF32 = 0, kDD = 1, kFX = 2;  // ops/perturbation.py TIERS
constexpr int kMandelbrot = 0, kJulia = 1, kShip = 2, kPhoenix = 3;
constexpr int kRebase = 0, kLedger = 1, kSingle = 2;  // ... FORMS
constexpr int kChunk = 16;  // the TPU kernel's orbit-index chunk

// Floats per entry of the orbit table: f32 tier (re, im); dd and floatexp
// tiers (re, im, re lo, im lo); the Julia floatexp tier (re, im, re lo, im
// lo, re exponent, im exponent, 0, 0) of the drift D = Z - Z0.
__host__ __device__ constexpr int orbit_width(int family, int tier) {
  return tier == kF32 ? 2 : (family == kJulia && tier == kFX ? 8 : 4);
}

// One orbit entry as a tier reads it; the fields it does not read are 0.
struct OrbitEntry {
  float re, im, rl, il, rex, iex;
};

// Entry i of the table: one 8- or 16-byte load (and one 8-byte load of the
// exponents in the Julia floatexp tier), so a step's address arithmetic is
// one index product.
template <int kFamily, int kTier>
static __device__ __forceinline__ OrbitEntry orbit_entry(const float* o,
                                                         int i) {
  const float* at = o + orbit_width(kFamily, kTier) * i;
  OrbitEntry e = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (kTier == kF32) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(at));
    e.re = v.x;
    e.im = v.y;
  } else {
    const float4 v = __ldg(reinterpret_cast<const float4*>(at));
    e.re = v.x;
    e.im = v.y;
    e.rl = v.z;
    e.il = v.w;
    if constexpr (orbit_width(kFamily, kTier) == 8) {
      const float2 w = __ldg(reinterpret_cast<const float2*>(at + 4));
      e.rex = w.x;
      e.iex = w.y;
    }
  }
  return e;
}

// The instances that exist: every family and tier rebasing; the ledger on
// the Burning Ship's dd and floatexp tiers; the single pass on Mandelbrot.
__host__ __device__ constexpr bool pert_instance(int family, int tier,
                                                 int form) {
  return form == kRebase || (form == kLedger && family == kShip &&
                             tier != kF32) ||
         (form == kSingle && family == kMandelbrot);
}

template <int kFamily, int kTier, int kForm>
__global__ void __launch_bounds__(256)
    pert_kernel(PertParams p, PertArgs a) {
  static_assert(pert_instance(kFamily, kTier, kForm), "no such instance");
  constexpr bool julia = kFamily == kJulia;
  constexpr bool ship = kFamily == kShip;
  constexpr bool phoenix = kFamily == kPhoenix;
  constexpr bool ledger = kForm == kLedger;
  constexpr bool single = kForm == kSingle;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int lrow = blockIdx.y * blockDim.y + threadIdx.y;
  const int seg = blockIdx.z;
  if (col >= a.width || lrow >= a.height) return;
  const float* __restrict__ orb = a.orbit;

  const int limit = static_cast<int>(p.v[Q_LIMIT]);
  const float limit_f = p.v[Q_LIMIT];
  const float bail2 = p.v[Q_BAIL2];
  // the single pass stops at the budget too (:514-515)
  const int pert_end = single
      ? min(limit, static_cast<int>(p.v[Q_REFLEN]) - 1)
      : static_cast<int>(p.v[Q_REFLEN]) - 1;
  const float pp = p.v[Q_PP], rr = p.v[Q_RR];
  const dd_t z0x = {p.v[Q_Z0XH], p.v[Q_Z0XL]};
  const dd_t z0y = {p.v[Q_Z0YH], p.v[Q_Z0YL]};

  // dc = step * (pixel - size/2 + offset) + shift, in dd (:441-467); a
  // stacked segment maps at offset ((seg mod spp)/spp, (seg div spp)/spp),
  // its rows from the band's global first row Q_AROW0
  const bool stacked = a.spp > 1;
  const int row0 = static_cast<int>(stacked ? p.v[Q_AROW0] : p.v[Q_ROW0]);
  const float fspp = static_cast<float>(a.spp);
  const float offx =
      stacked ? static_cast<float>(seg % a.spp) / fspp : p.v[Q_OFFX];
  const float offy =
      stacked ? static_cast<float>(seg / a.spp) / fspp : p.v[Q_OFFY];
  const dd_t step = {p.v[Q_PSH], p.v[Q_PSL]};
  const float half_w = static_cast<float>(a.width) * 0.5f;
  const float half_h = static_cast<float>(a.map_height) * 0.5f;
  const float nx = (static_cast<float>(col) - half_w) + offx;
  const float ny = (static_cast<float>(lrow + row0) - half_h) + offy;
  const dd_t dcx = dd_add(dd_mul_float(step, nx),
                          {p.v[Q_SHIFTXH], p.v[Q_SHIFTXL]});
  const dd_t dcy = dd_add(dd_mul_float(step, ny),
                          {p.v[Q_SHIFTYH], p.v[Q_SHIFTYL]});
  const float delta_r = dd_to_float(dcx);
  const float delta_i = dd_to_float(dcy);
  const int s_exp = static_cast<int>(p.v[Q_SEXP]);
  const int n0 = static_cast<int>(p.v[Q_NSKIP]);

  // series initial delta d_{n0} = ((C dc + B) dc + A) dc (:500-564); the
  // families start from A = 1, B = C = 0 (d = dc)
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
                 : clip_exp(k0 + static_cast<int>(p.v[Q_SE0]));
      const float dfac0 = pow2i(ex);
      dz0r = dd_to_float(dzr) * dfac0;
      dz0i = dd_to_float(dzi) * dfac0;
    } else {
      dz0r = dd_to_float(dzr);
      dz0i = dd_to_float(dzi);
    }
  }
  // the full start value (:566-586): Z_{n0} + d; Julia Z0 + D_{n0} + d
  const OrbitEntry z0 = orbit_entry<kFamily, kTier>(orb, n0);
  float zfr, zfi;
  rfe_t z0fe_x, z0fe_y;  // Julia floatexp: Z0
  rfe_t dcfe_x, dcfe_y;  // Ship floatexp: the true dc (:475-478)
  if constexpr (julia && kTier == kFX) {
    const rfe_t d0r = rfe_norm({z0.re, z0.rl}, static_cast<int>(z0.rex));
    const rfe_t d0i = rfe_norm({z0.im, z0.il}, static_cast<int>(z0.iex));
    zfr = z0x.hi + (z0x.lo + rfe_to_f32(rfe_add(d0r, {dzr, ex})));
    zfi = z0y.hi + (z0y.lo + rfe_to_f32(rfe_add(d0i, {dzi, ex})));
    z0fe_x = rfe_from_dd(z0x.hi, z0x.lo);
    z0fe_y = rfe_from_dd(z0y.hi, z0y.lo);
  } else if constexpr (julia) {
    zfr = z0x.hi + (z0x.lo + (z0.re + dz0r));
    zfi = z0y.hi + (z0y.lo + (z0.im + dz0i));
  } else {
    zfr = z0.re + dz0r;
    zfi = z0.im + dz0i;
  }
  if constexpr (ship && kTier == kFX) {
    dcfe_x = rfe_norm(dcx, -s_exp);
    dcfe_y = rfe_norm(dcy, -s_exp);
  }
  // the ledger starts at the dd compose floor of the initial delta, 2^-48
  // relative (:605-629); log2 of f32(1e-76) = 0 is -inf, as on the TPU
  float errx = 0.0f;
  if constexpr (ledger) {
    const float dmag0 = 0.5f * log2f(tmax(dzr.hi * dzr.hi + dzi.hi * dzi.hi,
                                          0.0f));
    if constexpr (kTier == kFX) {
      errx = ex == kEZero ? -200.0f
                          : (dmag0 + static_cast<float>(ex)) - 48.0f;
    } else {
      errx = dmag0 - 48.0f;
    }
  }
  float dr = dz0r, di = dz0i;  // f32 tier delta
  float qr = 0.0f, qi = 0.0f;  // f32 tier Phoenix delta_prev
  dd_t pzr = {0.0f, 0.0f}, pzi = {0.0f, 0.0f};  // dd / floatexp delta_prev
  int pex = kEZero;                             // floatexp delta_prev exp
  float nf = static_cast<float>(n0 - 1);

  int i = n0;
  int rounds = 1;
  bool want = false;
  bool glitch = false;  // the single pass's flag
  for (;;) {
    // Z_i, loaded where the lane's index jumps (n0, or 0 after a restart)
    // and from then on carried in registers: each step loads only
    // Z_{i+1}, which becomes the next step's Z_i
    OrbitEntry z = orbit_entry<kFamily, kTier>(orb, i);
    for (;;) {
      const float mag2 = zfr * zfr + zfi * zfi;
      if (!(mag2 <= bail2 && i < pert_end && nf < limit_f)) break;
      nf = nf + 1.0f;
      const OrbitEntry z1 = orbit_entry<kFamily, kTier>(orb, i + 1);
      const bool ends = i + 1 >= pert_end;
      bool want_now;
      if constexpr (kTier == kF32) {
        // :1070-1136; Julia's tables hold D = Z - Z0
        const float Zr = julia ? z0x.hi + z.re : z.re;
        const float Zi = julia ? z0y.hi + z.im : z.im;
        float ndr, ndi;
        if constexpr (ship) {
          // dx' = da(2|X|+da) - db(2|Y|+db) + dcx
          // dy' = 2(|X| db + |Y| da + da db) + dcy
          const float da = diffabs(Zr, dr), db = diffabs(Zi, di);
          const float aa = fabsf(Zr), bb = fabsf(Zi);
          ndr = da * (2.0f * aa + da) - db * (2.0f * bb + db) + delta_r;
          ndi = 2.0f * (aa * db + bb * da + da * db) + delta_i;
        } else {
          const float t1r = 2.0f * (Zr * dr - Zi * di);
          const float t1i = 2.0f * (Zr * di + Zi * dr);
          const float t2r = dr * dr - di * di;
          const float t2i = (2.0f * dr) * di;
          if constexpr (phoenix) {
            ndr = t1r + t2r + delta_r + pp * dr + rr * qr;
            ndi = t1i + t2i + delta_i + pp * di + rr * qi;
          } else if constexpr (julia) {
            ndr = t1r + t2r;
            ndi = t1i + t2i;
          } else {
            ndr = t1r + t2r + delta_r;
            ndi = t1i + t2i + delta_i;
          }
        }
        // Julia: rel = D_{i+1} + d (the rebased delta and the Zhuoran
        // distance to Z0); the others: rel is z_full
        const float relr = z1.re + ndr;
        const float reli = z1.im + ndi;
        const float zm2 = relr * relr + reli * reli;
        const float dm2 = ndr * ndr + ndi * ndi;
        want_now = !single && (zm2 < dm2 || ends) && nf < limit_f;
        if constexpr (phoenix) {
          // delta_prev advances to the old delta; a rebased lane gets the
          // absolute z_i (Z_{-1} = 0)
          qr = want_now ? Zr + dr : dr;
          qi = want_now ? Zi + di : di;
        }
        dr = want_now ? relr : ndr;
        di = want_now ? reli : ndi;
        if constexpr (julia) {
          zfr = z0x.hi + relr;
          zfi = z0y.hi + reli;
        } else {
          zfr = relr;
          zfi = reli;
        }
      } else {
        const dd_t X = {z.re, z.rl}, Y = {z.im, z.il};
        if constexpr (kTier == kDD) {
          // :926-1069
          dd_t ndr, ndi;
          if constexpr (ship) {
            const dd_t da = dd_diffabs(X, dzr), db = dd_diffabs(Y, dzi);
            const dd_t a2 = scl(dd_abs_by(X, dd_sign_nonneg(X)), 2.0f);
            const dd_t b2 = scl(dd_abs_by(Y, dd_sign_nonneg(Y)), 2.0f);
            ndr = dd_add(dd_sub(dd_mul(da, dd_add(a2, da)),
                                dd_mul(db, dd_add(b2, db))),
                         dcx);
            // 2(|X| db + |Y| da + da db) == A2*db + B2*da + 2*da*db
            const dd_t t2 = dd_add(dd_add(dd_mul(scl(a2, 0.5f), db),
                                          dd_mul(scl(b2, 0.5f), da)),
                                   dd_mul(da, db));
            ndi = dd_add(scl(t2, 2.0f), dcy);
          } else {
            dd_t z2r, z2i;
            if constexpr (julia) {  // Z = Z0 + D
              z2r = scl(dd_add(z0x, X), 2.0f);
              z2i = scl(dd_add(z0y, Y), 2.0f);
            } else {
              z2r = scl(X, 2.0f);
              z2i = scl(Y, 2.0f);
            }
            const dd_t t1r = dd_sub(dd_mul(dzr, z2r), dd_mul(dzi, z2i));
            const dd_t t1i = dd_add(dd_mul(dzi, z2r), dd_mul(dzr, z2i));
            const dd_t sq_r = dd_sub(dd_mul(dzr, dzr), dd_mul(dzi, dzi));
            const dd_t sq_i = scl(dd_mul(dzr, dzi), 2.0f);
            ndr = dd_add(t1r, sq_r);
            ndi = dd_add(t1i, sq_i);
            if constexpr (!julia) {
              ndr = dd_add(ndr, dcx);
              ndi = dd_add(ndi, dcy);
            }
            if constexpr (phoenix) {
              // dd_mul_float keeps the two-prod error term of p d, r d_prev
              ndr = dd_add(ndr, dd_add(dd_mul_float(dzr, pp),
                                       dd_mul_float(pzr, rr)));
              ndi = dd_add(ndi, dd_add(dd_mul_float(dzi, pp),
                                       dd_mul_float(pzi, rr)));
            }
          }
          const float rel_r = (z1.re + ndr.hi) + (z1.rl + ndr.lo);
          const float rel_i = (z1.im + ndi.hi) + (z1.il + ndi.lo);
          const float zm2 = rel_r * rel_r + rel_i * rel_i;
          const float dm2 = ndr.hi * ndr.hi + ndi.hi * ndi.hi;
          want_now = !single && (zm2 < dm2 || ends) && nf < limit_f;
          if (want_now) {  // rebase: d <- Z_{i+1} + d (Julia D_{i+1} + d)
            ndr = dd_add({z1.re, z1.rl}, ndr);
            ndi = dd_add({z1.im, z1.il}, ndi);
          }
          if constexpr (ledger) {
            // :1039-1065: the error grows by |2z| (z from the hi parts
            // before the step) and is floored at 2^-48 of the new delta
            const float fxr = X.hi + dzr.hi, fxi = Y.hi + dzi.hi;
            const float amp =
                0.5f * log2f(tmax(4.0f * (fxr * fxr + fxi * fxi), 1e-38f));
            const float flo =
                0.5f * log2f(tmax(ndr.hi * ndr.hi + ndi.hi * ndi.hi, 0.0f)) -
                48.0f;
            errx = tmax(errx + amp, flo);
          }
          if constexpr (phoenix) {
            pzr = want_now ? dd_add(X, dzr) : dzr;
            pzi = want_now ? dd_add(Y, dzi) : dzi;
          }
          dzr = ndr;
          dzi = ndi;
          if constexpr (julia) {
            zfr = z0x.hi + (z0x.lo + rel_r);
            zfi = z0y.hi + (z0y.lo + rel_i);
          } else {
            zfr = rel_r;
            zfi = rel_i;
          }
        } else if constexpr (julia) {
          // :692-712 and :817-845: d <- 2 Z d + d^2 entirely in floatexp
          // (Z itself can sit at delta scale near the start); rel = D_{i+1}
          // + d; z_full = Z0 + rel; the Zhuoran metric |rel| < |d| at full
          // floatexp precision
          const rfe_t Dr = rfe_norm(X, static_cast<int>(z.rex));
          const rfe_t Di = rfe_norm(Y, static_cast<int>(z.iex));
          cfe_t zc = cfe_from_rr(rfe_add(z0fe_x, Dr), rfe_add(z0fe_y, Di));
          zc.e = zc.e == kEZero ? zc.e : zc.e + 1;  // 2Z
          const cfe_t d = {dzr, dzi, ex};
          const cfe_t nm = cfe_add(cfe_mul(d, zc), cfe_mul(d, d));
          const rfe_t D1r =
              rfe_norm({z1.re, z1.rl}, static_cast<int>(z1.rex));
          const rfe_t D1i =
              rfe_norm({z1.im, z1.il}, static_cast<int>(z1.iex));
          const rfe_t rel_r = rfe_add(D1r, {nm.r, nm.e});
          const rfe_t rel_i = rfe_add(D1i, {nm.i, nm.e});
          const cfe_t rel_c = cfe_from_rr(rel_r, rel_i);
          zfr = z0x.hi + (z0x.lo + rfe_to_f32(rel_r));
          zfi = z0y.hi + (z0y.lo + rfe_to_f32(rel_i));
          want_now = !single && (cfe_mag2_lt(rel_c, nm) || ends) &&
                     nf < limit_f;
          const cfe_t nd = want_now ? rel_c : nm;
          dzr = nd.r;
          dzi = nd.i;
          ex = nd.e;
        } else {
          cfe_t nm;
          if constexpr (ship) {
            // :713-756: da is +-d away from the axes and +-(2X + d) on a
            // sign straddle, each a floatexp at its own scale
            const rfe_t dxfe = {dzr, ex}, dyfe = {dzi, ex};
            const bool xpos = dd_sign_nonneg(X), ypos = dd_sign_nonneg(Y);
            const dd_t ax = dd_abs_by(X, xpos), ay = dd_abs_by(Y, ypos);
            const rfe_t abs_x = rfe_from_dd(ax.hi, ax.lo);
            const rfe_t abs_y = rfe_from_dd(ay.hi, ay.lo);
            const rfe_t ux = rfe_add(rfe_from_dd(X.hi * 2.0f, X.lo * 2.0f),
                                     dxfe);
            const rfe_t uy = rfe_add(rfe_from_dd(Y.hi * 2.0f, Y.lo * 2.0f),
                                     dyfe);
            const bool sx = rfe_add(rfe_from_dd(X.hi, X.lo), dxfe).m.hi >= 0;
            const bool sy = rfe_add(rfe_from_dd(Y.hi, Y.lo), dyfe).m.hi >= 0;
            const rfe_t da =
                rfe_select(xpos, rfe_select(sx, dxfe, rfe_neg(ux)),
                           rfe_select(sx, ux, rfe_neg(dxfe)));
            const rfe_t db =
                rfe_select(ypos, rfe_select(sy, dyfe, rfe_neg(uy)),
                           rfe_select(sy, uy, rfe_neg(dyfe)));
            const rfe_t a2 = rfe_scale_pow2(abs_x, 1);
            const rfe_t b2 = rfe_scale_pow2(abs_y, 1);
            // dx' = da(2|X|+da) - db(2|Y|+db) + dcx
            // dy' = 2(|X| db + |Y| da + da db) + dcy
            const rfe_t dxp =
                rfe_add(rfe_add(rfe_mul(da, rfe_add(a2, da)),
                                rfe_neg(rfe_mul(db, rfe_add(b2, db)))),
                        dcfe_x);
            const rfe_t dyp = rfe_add(
                rfe_scale_pow2(rfe_add(rfe_add(rfe_mul(abs_x, db),
                                               rfe_mul(abs_y, da)),
                                       rfe_mul(da, db)),
                               1),
                dcfe_y);
            nm = cfe_from_rr(dxp, dyp);
          } else {
            // :764-816: the terms at exponents ex, 2ex and -s (Phoenix: and
            // ex, pex for p d and r d_prev) aligned to their max by exact
            // powers of two, then renormalised
            const dd_t z2r = scl(X, 2.0f), z2i = scl(Y, 2.0f);
            const dd_t t1r = dd_sub(dd_mul(dzr, z2r), dd_mul(dzi, z2i));
            const dd_t t1i = dd_add(dd_mul(dzi, z2r), dd_mul(dzr, z2i));
            const dd_t sq_r = dd_sub(dd_mul(dzr, dzr), dd_mul(dzi, dzi));
            const dd_t sq_i = scl(dd_mul(dzr, dzi), 2.0f);
            const int e2 = ex + ex;
            int emax = max(max(ex, e2), -s_exp);
            if constexpr (phoenix) {
              // a stale pex must not shift the real terms down when r = 0
              emax = max(emax, rr == 0.0f ? kEZero : pex);
            }
            const float fa = pow2i(ex - emax), fb = pow2i(e2 - emax);
            dd_t nmr = dd_add(scl(t1r, fa), scl(sq_r, fb));
            dd_t nmi = dd_add(scl(t1i, fa), scl(sq_i, fb));
            const float fc = pow2i(-s_exp - emax);
            nmr = dd_add(nmr, scl(dcx, fc));
            nmi = dd_add(nmi, scl(dcy, fc));
            if constexpr (phoenix) {
              nmr = dd_add(nmr, scl(dd_mul_float(dzr, pp), fa));
              nmi = dd_add(nmi, scl(dd_mul_float(dzi, pp), fa));
              const float fr = pow2i(pex - emax);
              nmr = dd_add(nmr, scl(dd_mul_float(pzr, rr), fr));
              nmi = dd_add(nmi, scl(dd_mul_float(pzi, rr), fr));
            }
            nm = cfe_norm(nmr, nmi, emax);
          }
          // :846-901: z_full = Z + m 2^ex; Zhuoran test; rebase to exp 0
          const float dfac = pow2i(nm.e);
          zfr = (z1.re + nm.r.hi * dfac) + (z1.rl + nm.r.lo * dfac);
          zfi = (z1.im + nm.i.hi * dfac) + (z1.il + nm.i.lo * dfac);
          const float zm2 = zfr * zfr + zfi * zfi;
          const float dm2 =
              (nm.r.hi * nm.r.hi + nm.i.hi * nm.i.hi) * pow2i(nm.e + nm.e);
          want_now = !single && (zm2 < dm2 || ends) && nf < limit_f;
          if constexpr (phoenix) {
            // delta_prev advances to the old delta; a rebased lane gets the
            // absolute z_i (dd, exponent 0)
            if (want_now) {
              const float dfo = pow2i(ex);
              pzr = dd_add(X, scl(dzr, dfo));
              pzi = dd_add(Y, scl(dzi, dfo));
              pex = 0;
            } else {
              pzr = dzr;
              pzi = dzi;
              pex = ex;
            }
          }
          if (want_now) {
            dzr = dd_add({z1.re, z1.rl}, scl(nm.r, dfac));
            dzi = dd_add({z1.im, z1.il}, scl(nm.i, dfac));
            ex = 0;
          } else {
            dzr = nm.r;
            dzi = nm.i;
            ex = nm.e;
          }
          if constexpr (ledger) {
            // :902-920: |2z| from the full z before the step; the floor
            // from the new (rebased) delta, none for an exact zero
            const float amp = 0.5f * log2f(tmax(4.0f * mag2, 1e-38f));
            const float flo =
                ex == kEZero
                    ? -1e9f
                    : (0.5f * log2f(tmax(dzr.hi * dzr.hi + dzi.hi * dzi.hi,
                                         0.0f)) +
                       static_cast<float>(ex)) -
                          48.0f;
            errx = tmax(errx + amp, flo);
          }
        }
      }
      if constexpr (single) {
        // the Pauldelbrot flag against |Z_{i+1}|^2 of the f32 hi streams,
        // the table the JAX package ships (:384-386, :1694-1695)
        glitch = glitch ||
                 zfr * zfr + zfi * zfi <
                     p.v[Q_GLITCH_TOL] * (z1.re * z1.re + z1.im * z1.im);
      }
      ++i;
      z = z1;
      if (want_now) {
        want = true;
        break;
      }
    }
    // the lane's next round: restart at orbit index 0, state carried over
    if (want && rounds < a.max_passes) {
      want = false;
      i = 0;
      ++rounds;
      continue;
    }
    break;
  }

  bool interior = nf >= limit_f;  // the budget ran out (:1265-1268)
  if constexpr (single) {
    // a lane alive at the orbit's end: flagged for a secondary reference,
    // or (float continuation) on in f32 from the chunk grid (:1222-1263)
    if (zfr * zfr + zfi * zfi <= bail2) {
      if (a.float_cont) {
        const float c_r =
            dd_to_float(dd_add({p.v[Q_CXH], p.v[Q_CXL]}, dcx));
        const float c_i =
            dd_to_float(dd_add({p.v[Q_CYH], p.v[Q_CYL]}, dcy));
        const int i1 = n0 + kChunk * ((max(pert_end - n0, 0) + kChunk - 1) /
                                      kChunk);
        for (int k = i1; k < limit && zfr * zfr + zfi * zfi <= bail2; ++k) {
          nf = nf + 1.0f;
          const float x = zfr * zfr - zfi * zfi + c_r;
          const float y = (2.0f * zfr) * zfi + c_i;
          zfr = x;
          zfi = y;
        }
      } else if (pert_end < limit) {
        glitch = true;
      }
    }
    interior = zfr * zfr + zfi * zfi <= bail2;  // (:1269-1271)
  }

  // :1272-1284
  const size_t idx =
      (static_cast<size_t>(seg) * a.height + lrow) * a.width + col;
  a.n[idx] = interior ? limit : static_cast<int>(fmaxf(nf, 0.0f));
  a.zx[idx] = zfr;
  a.zy[idx] = zfi;
  if constexpr (single) {
    a.glitch[idx] = glitch ? 1.0f : 0.0f;
  } else {
    a.want[idx] = want ? 1.0f : 0.0f;
    a.rounds[idx] = static_cast<float>(rounds);
  }
  if constexpr (ledger) {
    a.errx[idx] = errx;
  }
}

// Launch one instance (an error for a combination that has none): one
// thread per pixel of the band, grid.z = the spp^2 stacked segments.
// Returns the cudaError_t of the launch.
template <int kFamily, int kTier, int kForm>
int pert_launch_one(const PertParams& p, const PertArgs& a, cudaStream_t s) {
  if constexpr (pert_instance(kFamily, kTier, kForm)) {
    const dim3 block(32, 8);
    const dim3 grid((a.width + block.x - 1) / block.x,
                    (a.height + block.y - 1) / block.y, a.spp * a.spp);
    pert_kernel<kFamily, kTier, kForm><<<grid, block, 0, s>>>(p, a);
    return static_cast<int>(cudaGetLastError());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kFamily, int kForm>
int pert_launch_tier(int tier, const PertParams& p, const PertArgs& a,
                     cudaStream_t s) {
  switch (tier) {
    case kF32:
      return pert_launch_one<kFamily, kF32, kForm>(p, a, s);
    case kDD:
      return pert_launch_one<kFamily, kDD, kForm>(p, a, s);
    case kFX:
      return pert_launch_one<kFamily, kFX, kForm>(p, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch one family's instance of the given tier and form.
template <int kFamily>
int pert_launch(int tier, int form, const PertParams& p, const PertArgs& a,
                cudaStream_t s) {
  switch (form) {
    case kRebase:
      return pert_launch_tier<kFamily, kRebase>(tier, p, a, s);
    case kLedger:
      return pert_launch_tier<kFamily, kLedger>(tier, p, a, s);
    case kSingle:
      return pert_launch_tier<kFamily, kSingle>(tier, p, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One per family, each in its own translation unit (built in parallel).
int pert_launch_mandelbrot(int tier, int form, const PertParams& p,
                           const PertArgs& a, cudaStream_t s);
int pert_launch_julia(int tier, int form, const PertParams& p,
                      const PertArgs& a, cudaStream_t s);
int pert_launch_ship(int tier, int form, const PertParams& p,
                     const PertArgs& a, cudaStream_t s);
int pert_launch_phoenix(int tier, int form, const PertParams& p,
                        const PertArgs& a, cudaStream_t s);

#endif  // FR_PERT_KERNEL_CUH_
