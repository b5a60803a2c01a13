// Kernels #1 and #2, ungated, a whole block of 256 rays a CTA at 1 thread a
// ray (the unsplit kernel): see sweep_kernels.cuh.
#include "sweep_kernels.cuh"

namespace raystrack {

template void launch_sweep<1, 256, false, 1>(const Masks&, const Args&);
template void launch_sweep_sched<1, 256, false, 1>(const Sched&, const Args&);

}  // namespace raystrack
