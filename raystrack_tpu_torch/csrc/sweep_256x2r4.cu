// Kernels #1 and #2, ungated, 256 rays a CTA at 2 threads a ray and 4 rays
// a thread, at any count of tile segments: see sweep_kernels.cuh.
#include "sweep_kernels.cuh"

namespace raystrack {

template void launch_sweep<2, 256, false, 4>(const Masks&, const Args&);
template void launch_sweep_sched<2, 256, false, 4>(const Sched&, const Args&);

}  // namespace raystrack
