// Kernels #1 and #2, gated, 64 rays a CTA at 16 threads a ray and 4 rays a
// thread: see sweep_kernels.cuh.
#include "sweep_kernels.cuh"

namespace raystrack {

template void launch_sweep<16, 64, true, 4>(const Masks&, const Args&);
template void launch_sweep_sched<16, 64, true, 4>(const Sched&, const Args&);

}  // namespace raystrack
