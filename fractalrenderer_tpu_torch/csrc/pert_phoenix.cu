// K3's Phoenix (two-term recurrence) instances in the f32, dd and floatexp
// tiers, in a translation unit of their own so that nvcc builds the four
// families in parallel.  The kernel is csrc/pert_kernel.cuh.

#include "pert_kernel.cuh"

int pert_launch_phoenix(int tier, int form, const PertParams& p,
                        const PertArgs& a, cudaStream_t s) {
  return pert_launch<kPhoenix>(tier, form, p, a, s);
}
