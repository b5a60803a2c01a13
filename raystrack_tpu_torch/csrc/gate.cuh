// The ray-box slab test that the AABB distance gate runs in two places: per
// (ray, box) in the crossing kernel that builds the gate's tables (gate.cu)
// and per (ray, visited box) inside the gated sweeps (sweep_kernels.cuh).
// Both must round alike and like the plain version
// (ops/trace_cuda.py _ray_inv / _box_interval), so they share these device
// functions: every product and sum rounds on its own (the library is built
// --fmad=false), the reciprocal is an IEEE division, min and max propagate
// NaN as torch.minimum / torch.maximum do.
#pragma once

#include <cuda_runtime.h>

namespace raystrack {

constexpr float kInf = 1.0e20f;

// NaN-propagating min, as torch.minimum / jnp.minimum.
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// NaN-propagating max, as torch.maximum / jnp.maximum.
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The ray terms of the slab test, computed once per ray (_ray_inv).
struct RayInv {
  float inv[3];
  bool zero[3];
  bool pos[3];
};

__device__ __forceinline__ RayInv ray_inv(float dx, float dy, float dz) {
  const float d[3] = {dx, dy, dz};
  RayInv v;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v.zero[c] = fabsf(d[c]) <= 1e-30f;
    v.inv[c] = 1.0f / (v.zero[c] ? 1.0f : d[c]);
    v.pos[c] = d[c] >= 0.0f;
  }
  return v;
}

// The margined slab interval (near_c, far_c) of a ray from `o` against the
// box [lo, hi], in the op order of _box_interval. The relative margins keep
// it conservative against any faithful f32 evaluation. The ray crosses the
// box when slab_hit(near_c, far_c).
__device__ __forceinline__ void slab_interval(const float (&o)[3], const RayInv& v,
                                              const float (&lo)[3], const float (&hi)[3],
                                              float& near_c, float& far_c) {
  float near = 0.0f, far = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float t_n, t_f;
    if (v.zero[c]) {
      const bool inside = o[c] >= lo[c] && o[c] <= hi[c];
      t_n = inside ? -kInf : kInf;
      t_f = inside ? kInf : -kInf;
    } else {
      t_n = ((v.pos[c] ? lo[c] : hi[c]) - o[c]) * v.inv[c];
      t_f = ((v.pos[c] ? hi[c] : lo[c]) - o[c]) * v.inv[c];
    }
    near = c == 0 ? t_n : pmax(near, t_n);
    far = c == 0 ? t_f : pmin(far, t_f);
  }
  near_c = near - (fabsf(near) * 1e-4f + 1e-6f);
  far_c = far + (fabsf(far) * 1e-4f + 1e-6f);
}

__device__ __forceinline__ bool slab_hit(float near_c, float far_c) {
  return far_c >= near_c && far_c > 1e-6f;
}

}  // namespace raystrack
