// K3's entry point and its Mandelbrot instances (f32, dd and floatexp
// tiers, with the series-skip start).  The kernel, shared with the Julia,
// Burning Ship and Phoenix instances (csrc/pert_julia.cu, pert_ship.cu,
// pert_phoenix.cu), is csrc/pert_kernel.cuh; it replaces
// fractalrenderer_tpu/ops/perturbation.py:_make_kernel.

#include <cuda_runtime.h>

#include <cstring>

#include "pert_kernel.cuh"

int pert_launch_mandelbrot(int tier, const PertParams& p, const PertArgs& a,
                           cudaStream_t s) {
  return pert_launch<kMandelbrot>(tier, p, a, s);
}

extern "C" {

// Launch K3 for a family (0 Mandelbrot, 1 Julia, 2 Burning Ship, 3 Phoenix)
// and tier (0 f32, 1 dd, 2 floatexp deltas) on `stream`.  `params` (41
// floats) is a host array copied into the kernel's by-value argument; the
// six orbit streams are device arrays (those the tier does not read may
// alias the first); writes n (int32), zx, zy, want and rounds (f32), each
// (spp^2 * height, width), row-major, segment by segment.  Returns the
// cudaError_t of the launch.
int fr_perturbation(int family, int tier, const float* params,
                    const void* s0, const void* s1, const void* s2,
                    const void* s3, const void* s4, const void* s5,
                    int width, int height, int map_height, int max_passes,
                    int spp, void* n_out, void* zx_out, void* zy_out,
                    void* want_out, void* rounds_out, void* stream) {
  PertParams p;
  std::memcpy(p.v, params, sizeof(p.v));
  PertArgs a;
  const void* streams[6] = {s0, s1, s2, s3, s4, s5};
  for (int k = 0; k < 6; ++k) {
    a.orbit[k] = static_cast<const float*>(streams[k]);
  }
  a.width = width;
  a.height = height;
  a.map_height = map_height;
  a.max_passes = max_passes;
  a.spp = spp;
  a.n = static_cast<int*>(n_out);
  a.zx = static_cast<float*>(zx_out);
  a.zy = static_cast<float*>(zy_out);
  a.want = static_cast<float*>(want_out);
  a.rounds = static_cast<float*>(rounds_out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case kMandelbrot:
      return pert_launch_mandelbrot(tier, p, a, s);
    case kJulia:
      return pert_launch_julia(tier, p, a, s);
    case kShip:
      return pert_launch_ship(tier, p, a, s);
    case kPhoenix:
      return pert_launch_phoenix(tier, p, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
