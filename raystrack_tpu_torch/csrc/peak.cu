// FP32 FMA-peak probe: how many dependent-chain FFMAs per second the card
// issues when nothing else is in the way.
//
// Replaces the Pallas TPU kernel docs/measurements/vpu_roofline_r05.py
// measure_peak (body _fma_kernel): on a (32, 128) f32 block, 16 independent
// accumulators a_i = x + i each run 1,024 dependent a_i = a_i * c + d, and
// their sum (a_0 + a_1, + a_2, ...) is the output; the TPU repeats the block
// over a sequential grid of 2,048 steps, 1.374e11 FMAs in all. Here one
// thread owns one element of the block and keeps its 16 accumulators in
// registers; the repeats are independent blocks of the launch grid (16
// blocks of 256 threads per repeat), and every repeat writes its own copy
// of the (32, 128) result, so each can be checked.
//
// What bounds it: FP32 issue, by design. It reads 16 KB and writes 16 KB per
// repeat against 6.7e7 FFMAs. 16 chains per thread cover the FFMA latency
// several times over at any occupancy, and the depth loop is unrolled 16
// times (256 FFMAs between two loop branches) rather than fully: 16,384
// straight-line FFMAs would be 256 KB of code, more than the instruction
// cache holds.
//
// The sweeps are built with --fmad=false so that every product and sum
// rounds as PyTorch's eager ops do; this probe measures the fused
// instruction, so it asks for it by name (__fmaf_rn), whatever the flags.
// c and d are arguments, not literals: the compiler cannot fold the chains.
// An FFMA rounds once where a * c + d in tensor ops rounds twice, so the
// plain version (ops/peak_cuda.py fma_peak_reference) agrees to a stated
// tolerance, not bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32 * 128;  // elements of the (32, 128) block
constexpr int kThreads = 256;
constexpr int kChains = 16;
constexpr int kDepth = 1024;

__global__ void __launch_bounds__(kThreads)
fma_peak_kernel(const float* __restrict__ x, float c, float d, float* __restrict__ out) {
  constexpr int kBlocksPerRepeat = kBlock / kThreads;
  const int elem = (blockIdx.x % kBlocksPerRepeat) * kThreads + threadIdx.x;
  const size_t repeat = blockIdx.x / kBlocksPerRepeat;
  float a[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) a[i] = x[elem] + static_cast<float>(i);
#pragma unroll 16
  for (int k = 0; k < kDepth; ++k) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) a[i] = __fmaf_rn(a[i], c, d);
  }
  float s = a[0];
#pragma unroll
  for (int i = 1; i < kChains; ++i) s = s + a[i];
  out[repeat * kBlock + elem] = s;
}

}  // namespace

// Launches the probe on `stream` without synchronising and returns
// cudaGetLastError(). x is (32, 128) f32, out (repeats, 32, 128) f32; the
// launch runs repeats * 4096 * 16 * 1024 FFMAs.
extern "C" int raystrack_fma_peak(const float* x, float c, float d, int repeats, float* out,
                                  void* stream) {
  if (repeats < 0 || repeats > (1 << 20)) return static_cast<int>(cudaErrorInvalidValue);
  if (repeats == 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = static_cast<unsigned>(repeats) * (kBlock / kThreads);
  fma_peak_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, c, d, out);
  return static_cast<int>(cudaGetLastError());
}
