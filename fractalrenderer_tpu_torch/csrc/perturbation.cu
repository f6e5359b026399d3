// K3's entry point and its Mandelbrot instances (f32, dd and floatexp
// tiers, with the series-skip start), rebasing and single-pass.  The
// kernel, shared with the Julia, Burning Ship and Phoenix instances
// (csrc/pert_julia.cu, pert_ship.cu, pert_phoenix.cu), is
// csrc/pert_kernel.cuh; it replaces
// fractalrenderer_tpu/ops/perturbation.py:_make_kernel.

#include <cuda_runtime.h>

#include <cstring>

#include "pert_kernel.cuh"

int pert_launch_mandelbrot(int tier, int form, const PertParams& p,
                           const PertArgs& a, cudaStream_t s) {
  return pert_launch<kMandelbrot>(tier, form, p, a, s);
}

extern "C" {

// Launch K3 for a family (0 Mandelbrot, 1 Julia, 2 Burning Ship, 3 Phoenix),
// tier (0 f32, 1 dd, 2 floatexp deltas) and form (0 rebasing, 1 rebasing
// with the error ledger, 2 single pass) on `stream`.  `params` (41 floats)
// is a host array copied into the kernel's by-value argument; `orbit` is the
// device table of orbit_width(family, tier) floats per entry, 16-byte
// aligned; `float_cont` switches the single pass's f32 continuation on.
// Writes n (int32), zx, zy and the form's planes (f32): want and rounds
// (rebasing), glitch (single pass), errx (ledger), each (spp^2 * height,
// width), row-major, segment by segment; the pointers of the planes a form
// does not write may be null.  Returns the cudaError_t of the launch.
int fr_perturbation(int family, int tier, int form, const float* params,
                    const void* orbit, int width, int height,
                    int map_height, int max_passes, int spp,
                    int float_cont, void* n_out, void* zx_out,
                    void* zy_out, void* glitch_out, void* want_out,
                    void* rounds_out, void* errx_out, void* stream) {
  PertParams p;
  std::memcpy(p.v, params, sizeof(p.v));
  PertArgs a;
  a.orbit = static_cast<const float*>(orbit);
  a.width = width;
  a.height = height;
  a.map_height = map_height;
  a.max_passes = max_passes;
  a.spp = spp;
  a.float_cont = float_cont;
  a.n = static_cast<int*>(n_out);
  a.zx = static_cast<float*>(zx_out);
  a.zy = static_cast<float*>(zy_out);
  a.glitch = static_cast<float*>(glitch_out);
  a.want = static_cast<float*>(want_out);
  a.rounds = static_cast<float*>(rounds_out);
  a.errx = static_cast<float*>(errx_out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case kMandelbrot:
      return pert_launch_mandelbrot(tier, form, p, a, s);
    case kJulia:
      return pert_launch_julia(tier, form, p, a, s);
    case kShip:
      return pert_launch_ship(tier, form, p, a, s);
    case kPhoenix:
      return pert_launch_phoenix(tier, form, p, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
