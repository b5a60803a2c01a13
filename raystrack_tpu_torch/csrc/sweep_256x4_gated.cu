// Kernels #1 and #2, gated, a whole block of 256 rays a CTA at 4 threads a
// ray (the gated geometry before CTAs served part of a block): see
// sweep_kernels.cuh.
#include "sweep_kernels.cuh"

namespace raystrack {

template void launch_sweep<4, 256, true, 1>(const Masks&, const Args&);
template void launch_sweep_sched<4, 256, true, 1>(const Sched&, const Args&);

}  // namespace raystrack
