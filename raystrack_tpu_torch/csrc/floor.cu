// Two yardsticks for timing the other kernels; no solve calls them.
//
// empty_kernel is the launch floor: what one launch of a kernel that does
// nothing costs the card. spin_kernel holds the stream for a given time on
// %globaltimer, so that launches enqueued behind it run back to back on the
// card whatever the host's enqueue rate: CUDA events around such a run time
// the kernels, not the host that feeds them.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void spin_kernel(long long ns) {
  unsigned long long start, now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(start));
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  } while (static_cast<long long>(now - start) < ns);
}

}  // namespace

// One launch of the empty kernel (one block of 32 threads) on `stream`;
// returns cudaGetLastError().
extern "C" int raystrack_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// One thread that spins for `ns` nanoseconds on `stream`; returns
// cudaGetLastError().
extern "C" int raystrack_spin(long long ns, void* stream) {
  spin_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ns);
  return static_cast<int>(cudaGetLastError());
}
