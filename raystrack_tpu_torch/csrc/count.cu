// Exact per-row hit counts of the sweeps' codes: codes (rows, length) i32
// `2*sid + front` (-1 on a miss) -> counts (rows, n_codes) i32, where only
// each row's first n_valid[row] rays count and codes outside 0..n_codes-1
// count nowhere.
//
// Replaces the per-code compare-and-sum of the JAX package
// (raystrack_tpu/ops/trace.py count_code, an XLA reduction on the TPU), and
// the atomic histogram it stood in for here: every ray adding into one of a
// few global bins serialises on the bins' atomics. What bounds it: reading
// the codes, 4 bytes a ray, and contention on hot bins. So each block
// counts its slice of one row into bins in shared memory (shared atomics
// stay on the SM) and adds each non-zero bin to the global row once.
// Integer adds commute, so the counts are exact and do not depend on the
// order the blocks run in. Rows with more than kSmemBins codes (over 6,000
// surfaces) count straight into global memory, still exactly.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;       // codes per thread per block slice
constexpr int kSmemBins = 12288;    // 48 KB of int bins, no opt-in needed

__global__ void __launch_bounds__(kThreads)
count_codes_kernel(const int* __restrict__ codes, const int* __restrict__ n_valid,
                   int length, int n_codes, int blocks_per_row,
                   int* __restrict__ counts) {
  extern __shared__ int bins[];
  const int row = blockIdx.x / blocks_per_row;
  const int part = blockIdx.x - row * blocks_per_row;
  const bool in_shared = n_codes <= kSmemBins;  // uniform across the grid
  int* out = counts + static_cast<size_t>(row) * n_codes;
  if (in_shared) {
    for (int b = threadIdx.x; b < n_codes; b += kThreads) bins[b] = 0;
    __syncthreads();
  }
  const int valid = min(max(n_valid[row], 0), length);
  const int span = (length + blocks_per_row - 1) / blocks_per_row;
  const int begin = part * span;
  const int end = min(begin + span, valid);
  const int* row_codes = codes + static_cast<size_t>(row) * length;
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const int c = row_codes[i];
    if (c >= 0 && c < n_codes) atomicAdd(in_shared ? &bins[c] : &out[c], 1);
  }
  if (in_shared) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_codes; b += kThreads) {
      if (bins[b] != 0) atomicAdd(&out[b], bins[b]);
    }
  }
}

}  // namespace

// Adds the counts into `counts` (rows, n_codes), which the caller zeroes,
// on `stream` without synchronising; returns cudaGetLastError().
extern "C" int raystrack_count_codes(const int* codes, const int* n_valid, int rows,
                                     int length, int n_codes, int* counts,
                                     void* stream) {
  if (rows < 0 || length < 0 || n_codes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || length == 0 || n_codes == 0) return static_cast<int>(cudaSuccess);
  const int per_block = kThreads * kPerThread;
  const int blocks_per_row = (length + per_block - 1) / per_block;
  if (static_cast<long long>(rows) * blocks_per_row > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = n_codes <= kSmemBins ? n_codes * sizeof(int) : 0;
  count_codes_kernel<<<rows * blocks_per_row, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      codes, n_valid, length, n_codes, blocks_per_row, counts);
  return static_cast<int>(cudaGetLastError());
}
