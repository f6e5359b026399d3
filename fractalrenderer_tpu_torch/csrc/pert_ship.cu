// K3's Burning Ship (diffabs) instances in the f32, dd and floatexp
// tiers, in a translation unit of their own so that nvcc builds the four
// families in parallel.  The kernel is csrc/pert_kernel.cuh.

#include "pert_kernel.cuh"

int pert_launch_ship(int tier, const PertParams& p, const PertArgs& a,
                     cudaStream_t s) {
  return pert_launch<kShip>(tier, p, a, s);
}
