// Kernels #1 and #2, ungated, with 4 threads a ray (kSplit = 4): see sweep_kernels.cuh.
#include "sweep_kernels.cuh"

namespace raystrack {

template void launch_sweep<4, false>(const Masks&, const Args&);
template void launch_sweep_sched<4, false>(const Sched&, const Args&);

}  // namespace raystrack
