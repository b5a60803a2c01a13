// Kernels #1 and #2, gated, at the gated launches' 4 threads a ray: see
// sweep_kernels.cuh.
#include "sweep_kernels.cuh"

namespace raystrack {

template void launch_sweep<kGatedSplit, true>(const Masks&, const Args&);
template void launch_sweep_sched<kGatedSplit, true>(const Sched&, const Args&);

}  // namespace raystrack
