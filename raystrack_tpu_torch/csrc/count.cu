// Exact per-row hit counts of the sweeps' codes: codes (rows, length) i32
// `2*sid + front` (-1 on a miss) -> counts (rows, n_codes) i32. Ray i of a
// row counts when i < n_valid[row] (every ray when n_valid is null) and
// valid[row, i] (every ray when valid is null); codes outside 0..n_codes-1
// count nowhere. Nothing here is particular to hit codes: the sky solves
// count a missed ray's Tregenza patch (145 bins) or its upward flag (one
// bin) through the same entry (ops/count_cuda.py count_bins).
//
// Replaces the per-code compare-and-sum of the JAX package
// (raystrack_tpu/ops/trace.py count_code, an XLA reduction on the TPU). What
// bounds it: reading the codes, 4 bytes a ray; at the main path's sizes
// (a scheduled round's rows of 2,048 codes, a chunk's rows of up to 262,144)
// that is microseconds, so a launch is most of its cost. The design is one
// launch that writes every bin of every row, zeros included, so the caller
// allocates the counts with no zero-fill kernel before it:
//
// - a CTA counts kPerCta codes of one row into bins in shared memory; each
//   thread loads its eight codes before it counts any, so they are in
//   flight together (one load latency a CTA, not eight);
// - a row of at most kPerCta codes (a scheduled round's 2,048) is one
//   CTA's, which stores it;
// - a longer row (a chunk's) is spread over as many CTAs as it has slices
//   of kPerCta, so a 262,144-code row keeps 128 SMs busy. Each adds its
//   non-zero bins into the row's partial sums in a work buffer and takes a
//   ticket; the CTA that takes the row's last ticket reads the sums,
//   resetting them to zero as it reads (atomicExch), stores the row and
//   resets the ticket. The work buffer is zero before and after every
//   launch, so it is zeroed once, when it is allocated, and launches on
//   one stream share it;
// - rows of more than kSmemBins codes (over 6,144 surfaces) count straight
//   into global memory, which the caller zeroes first: the only path that
//   needs it.
//
// The adds are plain atomics. A row's rays fall on a handful of codes, but
// aggregating a warp's equal codes first (__match_any_sync, then one add a
// group) measured slower on the H100 than letting the shared-memory atomics
// of equal addresses serialise (PERF.md section 6). Integer adds commute,
// so the counts are exact and do not depend on the order in which threads
// and CTAs run.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;                   // codes a thread loads before it counts them
constexpr int kPerCta = kThreads * kUnroll;  // 2,048
constexpr int kSmemBins = 12288;             // 48 KB of int bins, no opt-in needed

// kShared: bins in shared memory and every count stored; else global
// atomics into zeroed counts. work: (rows, n_codes) partial sums, then
// (rows,) tickets, zero on entry and on exit; read only when a row has
// more than one CTA.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
count_codes_kernel(const int* __restrict__ codes, const int* __restrict__ n_valid,
                   const unsigned char* __restrict__ valid, int rows, int length, int n_codes,
                   int ctas_per_row, int* __restrict__ counts, int* __restrict__ work) {
  extern __shared__ int bins[];
  __shared__ bool last;
  const int row = blockIdx.x / ctas_per_row;
  const int part = blockIdx.x - row * ctas_per_row;
  int* out = counts + static_cast<size_t>(row) * n_codes;
  if (kShared) {
    for (int b = threadIdx.x; b < n_codes; b += kThreads) bins[b] = 0;
    __syncthreads();
  }
  const int n_count = n_valid ? min(max(n_valid[row], 0), length) : length;
  const int begin = part * kPerCta;
  const int end = min(begin + kPerCta, n_count);
  const int* row_codes = codes + static_cast<size_t>(row) * length;
  const unsigned char* row_valid = valid ? valid + static_cast<size_t>(row) * length : nullptr;
  int* target = kShared ? bins : out;
  int c[kUnroll];
  bool ok[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {  // each load is coalesced over the warp
    const int i = begin + u * kThreads + static_cast<int>(threadIdx.x);
    ok[u] = i < end && (row_valid == nullptr || row_valid[i] != 0);
    c[u] = i < end ? row_codes[i] : -1;
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (ok[u] && c[u] >= 0 && c[u] < n_codes) atomicAdd(&target[c[u]], 1);
  }
  if (!kShared) return;
  __syncthreads();  // this CTA's counts are in its bins
  if (ctas_per_row == 1) {
    for (int b = threadIdx.x; b < n_codes; b += kThreads) out[b] = bins[b];
    return;
  }
  int* sums = work + static_cast<size_t>(row) * n_codes;
  int* ticket = work + static_cast<size_t>(rows) * n_codes + row;
  for (int b = threadIdx.x; b < n_codes; b += kThreads) {
    if (bins[b] != 0) atomicAdd(&sums[b], bins[b]);
  }
  __threadfence();  // this CTA's sums are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == ctas_per_row - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other CTA's sums are visible to the last one
  for (int b = threadIdx.x; b < n_codes; b += kThreads) out[b] = atomicExch(&sums[b], 0);
  if (threadIdx.x == 0) *ticket = 0;
}

}  // namespace

// The most codes (2 per surface) a row may have for the counts to be
// written whole; past it the caller zeroes them first.
extern "C" int raystrack_count_smem_bins() { return kSmemBins; }

// The codes of a row that one CTA counts; a longer row needs the work
// buffer.
extern "C" int raystrack_count_per_cta() { return kPerCta; }

// Counts into `counts` (rows, n_codes) on `stream` without synchronising and
// returns cudaGetLastError() (0 when the launch was accepted). With
// n_codes <= raystrack_count_smem_bins() every count is written; above it
// the counts are added, and the caller zeroes them first. n_valid (rows,)
// and valid (rows, length) bytes may each be null. `work` holds
// rows * (n_codes + 1) ints, zero, when length > raystrack_count_per_cta()
// (it is zero again when the kernel ends; null otherwise), and belongs to
// `stream`: two launches that may overlap must not share it.
extern "C" int raystrack_count_codes(const int* codes, const int* n_valid,
                                     const unsigned char* valid, int rows, int length,
                                     int n_codes, int* counts, int* work, void* stream) {
  if (rows < 0 || length < 0 || n_codes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || n_codes == 0) return static_cast<int>(cudaSuccess);
  const bool shared = n_codes <= kSmemBins;
  if (!shared && length == 0) return static_cast<int>(cudaSuccess);  // nothing to add
  const int ctas_per_row = length <= kPerCta ? 1 : (length + kPerCta - 1) / kPerCta;
  if (shared && ctas_per_row > 1 && work == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(rows) * ctas_per_row > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows * ctas_per_row));
  if (shared) {
    count_codes_kernel<true><<<grid, kThreads, static_cast<size_t>(n_codes) * sizeof(int), st>>>(
        codes, n_valid, valid, rows, length, n_codes, ctas_per_row, counts, work);
  } else {
    count_codes_kernel<false><<<grid, kThreads, 0, st>>>(codes, n_valid, valid, rows, length,
                                                         n_codes, ctas_per_row, counts, work);
  }
  return static_cast<int>(cudaGetLastError());
}
