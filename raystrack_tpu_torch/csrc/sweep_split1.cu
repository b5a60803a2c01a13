// Kernels #1 and #2, ungated, with 1 thread a ray (kSplit = 1): see sweep_kernels.cuh.
#include "sweep_kernels.cuh"

namespace raystrack {

template void launch_sweep<1, false>(const Masks&, const Args&);
template void launch_sweep_sched<1, false>(const Sched&, const Args&);

}  // namespace raystrack
