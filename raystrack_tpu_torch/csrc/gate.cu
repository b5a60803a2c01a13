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
// What bounds it: issue slots. A (ray, box) pair is a slab test of some
// thirty instructions and no memory traffic to speak of: the inputs are 36
// bytes a ray and 24 a box, the outputs 5 bytes per (block, box). So the
// design strips the pair loop down to the slab test's own arithmetic:
//
// - one CTA per block of rays. It stages the block's rays once in shared
//   memory, origin and reciprocal direction (one IEEE division per ray and
//   component), and then loops over the boxes in slices of K boxes a thread
//   itself;
// - K boxes a thread, in registers, so each staged ray is read once for K
//   pairs and no reduction crosses threads. K and the CTA's threads follow
//   the box count, so few threads idle in the last slice: 1 box a thread in
//   CTAs of 64, 128 or 256 threads up to 256 boxes (the two-level gate's
//   few dozen), 2 up to 512 (the 1M-triangle city's 489), else 4 (the 10M
//   city's 4,883);
// - at staging the rays are grouped by octant, the signs of their three
//   direction components (one more group holds the rays with a component of
//   |d| <= 1e-30). Within an octant every ray meets a box's slabs in the
//   same planes, so a thread picks its boxes' near and far planes once per
//   octant and the pair is the bare subtract, multiply, max/min chain and
//   the margins. The zero-component group, which rays drawn from an
//   emitter's cosine-weighted hemisphere almost never join, takes the
//   general slab_interval;
// - max and min are PTX max.NaN / min.NaN: one instruction each, NaN from
//   either side, as pmax / pmin (gate.cuh) are in three. They differ from
//   those only in the sign of a zero result, and a margin of 1e-6 erases
//   that: near_c and far_c come out bitwise the same.
//
// OR and minimum are exact in any order, so neither the octant grouping nor
// the order of rays within a group changes a bit: the kernel is bitwise
// equal to its plain version (gate_cross_reference).
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

constexpr int kMaxThreads = 256;
constexpr int kStage = 1024;       // rays staged at once; a longer block is staged in parts
constexpr int kZeroGroup = 8;      // after the eight octants
constexpr int kGroups = kZeroGroup + 1;

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A ray's group: its octant (bit c set where d_c >= 0, the plain version's
// d_pos), or kZeroGroup when a component is |d_c| <= 1e-30.
__device__ __forceinline__ int ray_group(float dx, float dy, float dz) {
  if (fabsf(dx) <= 1e-30f || fabsf(dy) <= 1e-30f || fabsf(dz) <= 1e-30f) return kZeroGroup;
  return (dx >= 0.0f ? 1 : 0) | (dy >= 0.0f ? 2 : 0) | (dz >= 0.0f ? 4 : 0);
}

// The block's staged rays, grouped: group g holds [start[g], start[g + 1]).
struct Stage {
  float4* oi;  // origin, reciprocal x
  float2* yz;  // reciprocal y, z
  int* bits;   // zero (bit c) and d >= 0 (bit 3 + c) flags: read for the zero group only
  int* place;  // while staging: a ray's group and its slot in the group
  int* count;  // per group, while staging
  int* start;  // kGroups + 1 offsets
};

// Stages rays [r0, r0 + m) of `rays` (m <= kStage), grouped. Every thread
// of the CTA calls it.
__device__ void stage_rays(const Stage& s, const float* __restrict__ rays, size_t ns, size_t r0,
                           int m) {
  if (threadIdx.x < kGroups) s.count[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const size_t r = r0 + i;
    const int g = ray_group(rays[3 * ns + r], rays[4 * ns + r], rays[5 * ns + r]);
    s.place[i] = g << 16 | atomicAdd(&s.count[g], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s.start[0] = 0;
    for (int g = 0; g < kGroups; ++g) s.start[g + 1] = s.start[g] + s.count[g];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const size_t r = r0 + i;
    const RayInv v = ray_inv(rays[3 * ns + r], rays[4 * ns + r], rays[5 * ns + r]);
    const int at = s.start[s.place[i] >> 16] + (s.place[i] & 0xffff);
    s.oi[at] = make_float4(rays[r], rays[ns + r], rays[2 * ns + r], v.inv[0]);
    s.yz[at] = make_float2(v.inv[1], v.inv[2]);
    int bits = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) bits |= (v.zero[c] ? 1 << c : 0) | (v.pos[c] ? 8 << c : 0);
    s.bits[at] = bits;
  }
  __syncthreads();
}

// The staged rays against this thread's K boxes, into its running OR and
// minimum per box. pn and pf hold the boxes' near and far planes for the
// octant of all-positive directions, lo and hi; per octant they are swapped
// on the axes where its sign differs, in place, and swapped back at the end.
template <int K>
__device__ __forceinline__ void cross_staged(const Stage& s, float (&pn)[K][3],
                                             float (&pf)[K][3], bool (&any)[K],
                                             float (&nearest)[K]) {
  int held = 7;  // the octant whose planes pn and pf hold
  for (int g = 0; g < kZeroGroup; ++g) {
    const int i0 = s.start[g], i1 = s.start[g + 1];
    if (i0 == i1) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (((g ^ held) >> c) & 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float t = pn[k][c];
          pn[k][c] = pf[k][c];
          pf[k][c] = t;
        }
      }
    }
    held = g;
#pragma unroll 1
    for (int i = i0; i < i1; ++i) {
      const float4 a = s.oi[i];
      const float2 b = s.yz[i];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float near = max_nan(max_nan((pn[k][0] - a.x) * a.w, (pn[k][1] - a.y) * b.x),
                                   (pn[k][2] - a.z) * b.y);
        const float far = min_nan(min_nan((pf[k][0] - a.x) * a.w, (pf[k][1] - a.y) * b.x),
                                  (pf[k][2] - a.z) * b.y);
        const float near_c = near - (fabsf(near) * 1e-4f + 1e-6f);
        const float far_c = far + (fabsf(far) * 1e-4f + 1e-6f);
        if (slab_hit(near_c, far_c)) {
          any[k] = true;
          nearest[k] = fminf(nearest[k], near_c);  // a hit's near_c is never NaN
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {  // back to lo and hi
    if (((7 ^ held) >> c) & 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float t = pn[k][c];
        pn[k][c] = pf[k][c];
        pf[k][c] = t;
      }
    }
  }
  for (int i = s.start[kZeroGroup]; i < s.start[kGroups]; ++i) {
    const float4 a = s.oi[i];
    const float2 b = s.yz[i];
    const int bits = s.bits[i];
    const float o[3] = {a.x, a.y, a.z};
    RayInv v;
    v.inv[0] = a.w;
    v.inv[1] = b.x;
    v.inv[2] = b.y;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v.zero[c] = (bits & (1 << c)) != 0;
      v.pos[c] = (bits & (8 << c)) != 0;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float near_c, far_c;
      slab_interval(o, v, pn[k], pf[k], near_c, far_c);
      if (slab_hit(near_c, far_c)) {
        any[k] = true;
        if (near_c < nearest[k]) nearest[k] = near_c;
      }
    }
  }
}

// K boxes a thread, blockDim.x threads (64, 128 or 256): slices of
// K * blockDim.x boxes.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
gate_cross_kernel(const float* __restrict__ rays, int n, const float* __restrict__ boxes,
                  int n_boxes, int ray_block, unsigned char* __restrict__ crossed,
                  float* __restrict__ minnear) {
  extern __shared__ float4 staged[];
  __shared__ int s_count[kGroups];
  __shared__ int s_start[kGroups + 1];
  const int stage_len = ray_block < kStage ? ray_block : kStage;
  Stage s;
  s.oi = staged;
  s.yz = reinterpret_cast<float2*>(staged + stage_len);
  s.bits = reinterpret_cast<int*>(s.yz + stage_len);
  s.place = s.bits + stage_len;
  s.count = s_count;
  s.start = s_start;

  const size_t ns = static_cast<size_t>(n);
  const size_t first = static_cast<size_t>(blockIdx.x) * ray_block;
  const size_t last = first + ray_block < ns ? first + ray_block : ns;  // rays past N cross nothing
  const bool once = last - first <= static_cast<size_t>(stage_len);
  if (once) stage_rays(s, rays, ns, first, static_cast<int>(last - first));
  const int threads = blockDim.x;
  for (int slice = 0; slice < n_boxes; slice += K * threads) {
    float lo[K][3], hi[K][3];  // the planes cross_staged swaps per octant
    bool any[K];
    float nearest[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int box = slice + k * threads + threadIdx.x;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[k][c] = box < n_boxes ? boxes[6 * static_cast<size_t>(box) + c] : 0.0f;
        hi[k][c] = box < n_boxes ? boxes[6 * static_cast<size_t>(box) + 3 + c] : 0.0f;
      }
      any[k] = false;
      nearest[k] = kInf;
    }
    if (once) {
      cross_staged<K>(s, lo, hi, any, nearest);
    } else {
      for (size_t base = first; base < last; base += stage_len) {
        const size_t end = base + stage_len < last ? base + stage_len : last;
        stage_rays(s, rays, ns, base, static_cast<int>(end - base));
        cross_staged<K>(s, lo, hi, any, nearest);
        __syncthreads();  // the staged rays are no longer read
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int box = slice + k * threads + threadIdx.x;
      if (box < n_boxes) {
        const size_t at = static_cast<size_t>(blockIdx.x) * n_boxes + box;
        crossed[at] = any[k] ? 1 : 0;
        minnear[at] = nearest[k];
      }
    }
  }
}

template <int K>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream, const float* rays,
                   int n, const float* boxes, int n_boxes, int ray_block,
                   unsigned char* crossed, float* minnear) {
  gate_cross_kernel<K><<<grid, threads, smem, stream>>>(rays, n, boxes, n_boxes, ray_block,
                                                        crossed, minnear);
  return cudaGetLastError();
}

}  // namespace

// Launches the crossing kernel on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was accepted). crossed and minnear
// hold ceil(n / ray_block) rows of n_boxes. The shape leaves few threads
// idle in the last slice: up to 256 boxes one a thread, in CTAs of 64, 128
// or 256 threads; up to 512 two a thread; past that four, in slices of
// 1,024.
extern "C" int raystrack_gate_cross(const float* rays, int n, const float* boxes, int n_boxes,
                                    int ray_block, unsigned char* crossed, float* minnear,
                                    void* stream) {
  if (n < 0 || n_boxes < 0 || ray_block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || n_boxes == 0) return static_cast<int>(cudaSuccess);
  const long long n_blocks = (static_cast<long long>(n) + ray_block - 1) / ray_block;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int stage_len = ray_block < kStage ? ray_block : kStage;
  const size_t smem = static_cast<size_t>(stage_len) *
                      (sizeof(float4) + sizeof(float2) + 2 * sizeof(int));
  const dim3 grid(static_cast<unsigned>(n_blocks));
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n_boxes <= kMaxThreads) {
    const int threads = n_boxes <= 64 ? 64 : n_boxes <= 128 ? 128 : 256;
    err = launch<1>(grid, threads, smem, st, rays, n, boxes, n_boxes, ray_block, crossed,
                    minnear);
  } else if (n_boxes <= 2 * kMaxThreads) {
    err = launch<2>(grid, kMaxThreads, smem, st, rays, n, boxes, n_boxes, ray_block, crossed,
                    minnear);
  } else {
    err = launch<4>(grid, kMaxThreads, smem, st, rays, n, boxes, n_boxes, ray_block, crossed,
                    minnear);
  }
  return static_cast<int>(err);
}
