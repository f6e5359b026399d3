// K3's Burning Ship (diffabs) instances in the f32, dd and floatexp
// tiers, and the dd and floatexp tiers again with the exact-dust error
// ledger (the errx plane), in a translation unit of their own so that nvcc
// builds the four families in parallel.  The kernel is
// csrc/pert_kernel.cuh.

#include "pert_kernel.cuh"

int pert_launch_ship(int tier, int form, const PertParams& p,
                     const PertArgs& a, cudaStream_t s) {
  return pert_launch<kShip>(tier, form, p, a, s);
}
