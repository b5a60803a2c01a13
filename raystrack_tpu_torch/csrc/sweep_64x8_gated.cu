// Kernels #1 and #2, gated, 64 rays a CTA at 8 threads a ray: see
// sweep_kernels.cuh.
#include "sweep_kernels.cuh"

namespace raystrack {

template void launch_sweep<8, 64, true>(const Masks&, const Args&);
template void launch_sweep_sched<8, 64, true>(const Sched&, const Args&);

}  // namespace raystrack
