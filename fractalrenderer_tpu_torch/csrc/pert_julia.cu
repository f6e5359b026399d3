// K3's Julia instances (drift table D = Z - Z0; the floatexp tier reads the
// drift's exponents) in the f32, dd and floatexp tiers, in a translation
// unit of their own so that nvcc builds the four families in parallel.  The
// kernel is csrc/pert_kernel.cuh.

#include "pert_kernel.cuh"

int pert_launch_julia(int tier, int form, const PertParams& p,
                      const PertArgs& a, cudaStream_t s) {
  return pert_launch<kJulia>(tier, form, p, a, s);
}
