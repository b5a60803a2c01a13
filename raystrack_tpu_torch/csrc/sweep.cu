// Möller–Trumbore sweep of rays against every triangle of a scene.
//
// Replaces the Pallas TPU kernel raystrack_tpu/ops/trace_pallas.py
// sweep_rays (bodies _sweep_kernel / _sweep_kernel_streamed, shared tile
// math _tile_step). For each ray it returns the nearest eligible hit packed
// as 2*sid + front (-1 on a miss) and a 0/1 any-hit flag.
//
// What bounds it: FP32 ALU work. Each ray-triangle pair costs about 42
// flops plus about 14 compares and selects; a triangle's operands are 76
// bytes, read once per block of rays. So each block stages a tile of
// triangle operands in shared memory (coalesced loads along the pack's
// triangle axis) and every thread, one per ray, loops over the staged tile
// reading the operands as broadcast 16-byte loads. The t = t_num / det
// division runs only for pairs whose barycentric tests pass.
//
// Exactness: built with --fmad=false and without fast math, every product
// and sum rounds as PyTorch's eager ops do and the division is IEEE, in the
// association order of _tile_step; the nearest-hit fold keeps its tie rule
// (smallest code among equal t inside a sweep tile, strictly smaller t
// across tiles). The kernel is bitwise equal to sweep_rays_reference.
//
// Layouts (see ops/trace_cuda.py): rays (9, N) f32 rows [o | d | o x d];
// pack (24, Tpad) f32 rows 0-2 cross_e, 3-5 e1, 6-8 e2, 9-11 v0 x e2,
// 12-14 v0 x e1, 15 d0, 16 2*sid, 17 mask_any, 18 mask_mat; tiles_on
// (Tpad / tile,) i32; codes and any (N,) i32.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // rays per block, one per thread
constexpr int kStage = 128;    // triangles per shared-memory stage
constexpr int kUsedRows = 19;  // pack rows the sweep reads
constexpr float kInf = 1.0e20f;

// One staged triangle: the 19 operand rows in five 16-byte groups.
struct alignas(16) Tri {
  float4 ce_d0;    // cross_e, d0
  float4 e1_code;  // e1, 2*sid
  float4 e2_many;  // e2, mask_any
  float4 wu_mmat;  // v0 x e2, mask_mat
  float4 wv;       // v0 x e1, unused
};

// Float offset of pack row `row` inside Tri.
__device__ __forceinline__ int tri_slot(int row) {
  return row < 15 ? (row / 3) * 4 + row % 3 : (row - 15) * 4 + 3;
}

// NaN-propagating min, as torch.minimum / jnp.minimum.
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

template <bool kMatrix, bool kAny, bool kBaked>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ rays, int n,
             const float* __restrict__ pack, int n_tri_pad,
             const int* __restrict__ tiles_on, int tile,
             int* __restrict__ codes, int* __restrict__ any_out) {
  // A baked pack folds the primary mask (m_any when any-hits are wanted,
  // else m_mat) into zeroed cross_e rows; only the other test survives.
  // (trace_cuda._mask_tests states the same rule for the plain version.)
  constexpr bool kTestAny = !kBaked;
  constexpr bool kTestMat = !(kBaked && !kAny);
  __shared__ Tri stage[kStage];
  float* stage_f = reinterpret_cast<float*>(stage);

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < n;
  // threads past the last ray still load stages and reach every barrier
  const size_t r = live ? static_cast<size_t>(ray) : 0;
  const size_t ns = static_cast<size_t>(n);
  const float ox = rays[0 * ns + r], oy = rays[1 * ns + r], oz = rays[2 * ns + r];
  const float dx = rays[3 * ns + r], dy = rays[4 * ns + r], dz = rays[5 * ns + r];
  const float cx = rays[6 * ns + r], cy = rays[7 * ns + r], cz = rays[8 * ns + r];

  float best_t = kInf;
  int best_code = -1;
  int any_hit = 0;
  const int n_tiles = n_tri_pad / tile;
  for (int it = 0; it < n_tiles; ++it) {
    if (tiles_on[it] == 0) continue;  // no eligible triangle: exact skip
    float tile_t = kInf;
    int tile_code = 1 << 30;
    const int tile_end = (it + 1) * tile;
    for (int base = it * tile; base < tile_end; base += kStage) {
      __syncthreads();  // the previous stage is no longer read
      for (int idx = threadIdx.x; idx < kUsedRows * kStage; idx += kThreads) {
        const int row = idx / kStage;
        const int k = idx - row * kStage;
        stage_f[k * 20 + tri_slot(row)] =
            pack[static_cast<size_t>(row) * n_tri_pad + base + k];
      }
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < kStage; ++j) {
        const float4 ce = stage[j].ce_d0;
        const float4 e1 = stage[j].e1_code;
        const float4 e2 = stage[j].e2_many;
        const float4 wu = stage[j].wu_mmat;
        const float4 wv = stage[j].wv;
        // det = -(d . cross_e); t_num = o . cross_e - d0
        const float det = -(dx * ce.x + dy * ce.y + dz * ce.z);
        const float t_num = ox * ce.x + oy * ce.y + oz * ce.z - ce.w;
        // u_num = (o x d) . e2 + d . (v0 x e2)
        const float u_num =
            cx * e2.x + cy * e2.y + cz * e2.z + dx * wu.x + dy * wu.y + dz * wu.z;
        // v_num = -((o x d) . e1) - d . (v0 x e1)
        const float v_num =
            -(cx * e1.x + cy * e1.y + cz * e1.z + dx * wv.x + dy * wv.y + dz * wv.z);
        const float sign = det >= 0.0f ? 1.0f : -1.0f;
        const float abs_det = det * sign;
        const float un = u_num * sign;
        const float vn = v_num * sign;
        const float margin =
            pmin(pmin(abs_det - 1e-7f, un), pmin(vn, abs_det - (un + vn)));
        if (!(margin >= 0.0f)) continue;
        const float t = t_num / det;
        if (!(t > 1e-6f)) continue;
        if (kAny && (!kTestAny || e2.w > 0.0f)) any_hit = 1;
        if (kMatrix && (!kTestMat || wu.w > 0.0f)) {
          const int code = static_cast<int>(e1.w) + (det > 0.0f ? 1 : 0);
          if (t < tile_t) {
            tile_t = t;
            tile_code = code;
          } else if (t == tile_t && code < tile_code) {
            tile_code = code;
          }
        }
      }
    }
    if (kMatrix && tile_t < best_t) {
      best_t = tile_t;
      best_code = tile_code;
    }
  }
  if (live) {
    codes[ray] = best_t < kInf ? best_code : -1;
    any_out[ray] = any_hit;
  }
}

struct Args {
  const float* rays;
  int n;
  const float* pack;
  int n_tri_pad;
  const int* tiles_on;
  int tile;
  int* codes;
  int* any_out;
  cudaStream_t stream;
};

template <bool kMatrix, bool kAny>
void launch(bool baked, const Args& a) {
  const dim3 grid((a.n + kThreads - 1) / kThreads);
  if (baked) {
    sweep_kernel<kMatrix, kAny, true><<<grid, kThreads, 0, a.stream>>>(
        a.rays, a.n, a.pack, a.n_tri_pad, a.tiles_on, a.tile, a.codes, a.any_out);
  } else {
    sweep_kernel<kMatrix, kAny, false><<<grid, kThreads, 0, a.stream>>>(
        a.rays, a.n, a.pack, a.n_tri_pad, a.tiles_on, a.tile, a.codes, a.any_out);
  }
}

}  // namespace

// Launches the sweep on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was accepted). `tile` must be a
// multiple of 128 that divides n_tri_pad; at least one output is wanted.
extern "C" int raystrack_sweep_rays(const float* rays, int n, const float* pack,
                                    int n_tri_pad, const int* tiles_on, int tile,
                                    int want_matrix, int want_any, int masks_baked,
                                    int* codes, int* any_out, void* stream) {
  if (n < 0 || tile <= 0 || tile % kStage != 0 || n_tri_pad % tile != 0 ||
      !(want_matrix || want_any)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Args a{rays, n, pack, n_tri_pad, tiles_on, tile, codes, any_out,
               static_cast<cudaStream_t>(stream)};
  const bool baked = masks_baked != 0;
  if (want_matrix && want_any) {
    launch<true, true>(baked, a);
  } else if (want_matrix) {
    launch<true, false>(baked, a);
  } else {
    launch<false, true>(baked, a);
  }
  return static_cast<int>(cudaGetLastError());
}
