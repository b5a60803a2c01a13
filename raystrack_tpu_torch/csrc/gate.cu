// The crossing pass of the AABB distance gate's tables: for every block of
// rays and every gate box, whether some ray of the block statically crosses
// the box, and the smallest near bound among the rays that do.
//
// It replaces no Pallas kernel: the JAX package computes these two tables in
// XLA ops outside its sweeps (raystrack_tpu/ops/trace_pallas.py
// _gate_tables, block_union, lines 790-820), a (rays x boxes) slab reduced
// over each block's rays. In eager tensor ops that slab costs about ninety
// small kernels per step of a few blocks, thousands per gated dispatch, and
// more device time than the gated sweep loses to its bound; no library call
// computes it. So it is one kernel here. The sort, the suffix minimum and the
// small reductions around it stay tensor ops (ops/trace_cuda.py
// _gate_tables).
//
// What bounds it: FP32 operations. A (ray, box) pair costs about fifty FP32
// instructions and no memory traffic to speak of: the inputs are 36 bytes a
// ray and 24 a box, the outputs 5 bytes per (block, box). The layout keeps
// the instruction stream at that arithmetic: a CUDA block takes one block of
// rays and a slice of 256 boxes; it puts the rays' origins, reciprocal
// directions and direction flags into shared memory once, 256 rays at a
// time; then each thread owns one box (six registers) and loops over the
// rays as broadcast 16-byte shared loads, keeping its own running OR and
// minimum. No reduction crosses threads, so nothing synchronises but the
// ray staging, and OR and minimum are exact in any order: the kernel is
// bitwise equal to its plain version (gate_cross_reference).
//
// Layouts: rays (9, N) f32 rows [o | d | o x d] (rows 0-5 are read); boxes
// (n_boxes, 6) f32 [lo_x, lo_y, lo_z, hi_x, hi_y, hi_z]; crossed (n_blocks,
// n_boxes) one byte 0/1; minnear (n_blocks, n_boxes) f32, 1e20 where no ray
// crosses. Block b holds rays [b * ray_block, min(N, (b + 1) * ray_block)).
#include <cuda_runtime.h>

#include <cstddef>

#include "gate.cuh"

namespace {

using namespace raystrack;

constexpr int kThreads = 256;  // boxes per CUDA block, one per thread; rays per staging step

__global__ void __launch_bounds__(kThreads)
gate_cross_kernel(const float* __restrict__ rays, int n, const float* __restrict__ boxes,
                  int n_boxes, int ray_block, unsigned char* __restrict__ crossed,
                  float* __restrict__ minnear) {
  __shared__ float4 s_o[kThreads];    // origin, direction flags in the bits of w
  __shared__ float4 s_inv[kThreads];  // reciprocal direction
  const int box = blockIdx.y * kThreads + threadIdx.x;
  const bool owns = box < n_boxes;
  float lo[3] = {0.0f, 0.0f, 0.0f}, hi[3] = {0.0f, 0.0f, 0.0f};
  if (owns) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = boxes[6 * static_cast<size_t>(box) + c];
      hi[c] = boxes[6 * static_cast<size_t>(box) + 3 + c];
    }
  }
  const size_t ns = static_cast<size_t>(n);
  const size_t first = static_cast<size_t>(blockIdx.x) * ray_block;
  const size_t last = first + ray_block < ns ? first + ray_block : ns;  // rays past N cross nothing
  bool any = false;
  float nearest = kInf;
  for (size_t base = first; base < last; base += kThreads) {
    __syncthreads();  // the previous rays are no longer read
    const size_t r = base + threadIdx.x;
    if (r < last) {
      const RayInv v = ray_inv(rays[3 * ns + r], rays[4 * ns + r], rays[5 * ns + r]);
      int bits = 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) bits |= (v.zero[c] ? 1 << c : 0) | (v.pos[c] ? 8 << c : 0);
      s_o[threadIdx.x] = make_float4(rays[r], rays[ns + r], rays[2 * ns + r],
                                     __int_as_float(bits));
      s_inv[threadIdx.x] = make_float4(v.inv[0], v.inv[1], v.inv[2], 0.0f);
    }
    __syncthreads();
    if (!owns) continue;
    const int count = last - base < kThreads ? static_cast<int>(last - base) : kThreads;
    for (int i = 0; i < count; ++i) {
      const float4 ro = s_o[i];
      const float4 ri = s_inv[i];
      const int bits = __float_as_int(ro.w);
      const float o[3] = {ro.x, ro.y, ro.z};
      RayInv v;
      v.inv[0] = ri.x;
      v.inv[1] = ri.y;
      v.inv[2] = ri.z;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v.zero[c] = (bits & (1 << c)) != 0;
        v.pos[c] = (bits & (8 << c)) != 0;
      }
      float near_c, far_c;
      slab_interval(o, v, lo, hi, near_c, far_c);
      if (slab_hit(near_c, far_c)) {
        any = true;
        if (near_c < nearest) nearest = near_c;
      }
    }
  }
  if (owns) {
    const size_t at = static_cast<size_t>(blockIdx.x) * n_boxes + box;
    crossed[at] = any ? 1 : 0;
    minnear[at] = nearest;
  }
}

}  // namespace

// Launches the crossing kernel on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was accepted). crossed and minnear
// hold ceil(n / ray_block) rows of n_boxes.
extern "C" int raystrack_gate_cross(const float* rays, int n, const float* boxes, int n_boxes,
                                    int ray_block, unsigned char* crossed, float* minnear,
                                    void* stream) {
  if (n < 0 || n_boxes < 0 || ray_block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || n_boxes == 0) return static_cast<int>(cudaSuccess);
  const long long n_blocks = (static_cast<long long>(n) + ray_block - 1) / ray_block;
  const int slices = (n_boxes + kThreads - 1) / kThreads;
  if (slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(slices));
  gate_cross_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, n, boxes, n_boxes, ray_block, crossed, minnear);
  return static_cast<int>(cudaGetLastError());
}
