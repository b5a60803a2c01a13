// Möller–Trumbore sweeps of rays against every triangle of a scene.
//
// Kernel #1, sweep_kernel, replaces the Pallas TPU kernel
// raystrack_tpu/ops/trace_pallas.py sweep_rays (bodies _sweep_kernel /
// _sweep_kernel_streamed): all rays belong to one emitter. Kernel #2,
// sweep_sched_kernel, replaces sweep_rays_scheduled (bodies
// _sweep_kernel_sched / _sweep_kernel_sched_streamed): each block of 256
// rays belongs to the emitter row emap names, and takes its eligibility
// from that emitter's combined mask row (m_any + m_mat in {0, 1, 2}: any-hit
// if > 0, matrix if > 1) and its row of the (E, n_tiles) tile table. For
// each ray both return the nearest eligible hit packed as 2*sid + front (-1
// on a miss) and a 0/1 any-hit flag. The TPU shares its tile math,
// _tile_step, between the two; here both kernels run the same device
// functions stage_tile, pair_hit and sweep_ray, so on the same rays and the
// same eligibility they give the same bits.
//
// What bounds them: FP32 ALU work. Each ray-triangle pair costs about 42
// flops plus about 14 compares and selects; a triangle's operands are 76
// bytes, read once per block of rays. So each block stages a tile of
// triangle operands in shared memory (coalesced loads along the pack's
// triangle axis) and every thread, one per ray, loops over the staged tile
// reading the operands as broadcast 16-byte loads. Kernel #2 stages its
// emitter's mask row slice in the same stage, in the slot kernel #1 leaves
// unused, so the per-pair mask test costs one shared load. The
// t = t_num / det division runs only for pairs whose barycentric tests pass.
// Kernel #2 reads its tile table from global memory at every size: the
// TPU's union fallback past SCHED_TILES_SMEM_BUDGET is a limit of its scalar
// memory that this card does not have.
//
// Exactness: built with --fmad=false and without fast math, every product
// and sum rounds as PyTorch's eager ops do and the division is IEEE, in the
// association order of _tile_step; the nearest-hit fold keeps its tie rule
// (smallest code among equal t inside a sweep tile, strictly smaller t
// across tiles). Each kernel is bitwise equal to its plain version
// (sweep_rays_reference, sweep_rays_scheduled_reference).
//
// Layouts (see ops/trace_cuda.py): rays (9, N) f32 rows [o | d | o x d];
// pack (24, Tpad) f32 rows 0-2 cross_e, 3-5 e1, 6-8 e2, 9-11 v0 x e2,
// 12-14 v0 x e1, 15 d0, 16 2*sid, 17 mask_any, 18 mask_mat; tiles_on
// (Tpad / tile,) i32 for kernel #1, (E, Tpad / tile) i32 for kernel #2;
// masks (E, Tpad) f32 and emap (N / 256,) i32 for kernel #2; codes and any
// (N,) i32.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;   // rays per block, one per thread
constexpr int kStage = 128;     // triangles per shared-memory stage
constexpr int kUsedRows = 19;   // pack rows kernel #1 reads
constexpr int kCodeRows = 17;   // pack rows kernel #2 reads (no mask rows)
constexpr int kMaskSlot = 19;   // Tri float slot of kernel #2's mask row
constexpr float kInf = 1.0e20f;

// One staged triangle: the operand rows in five 16-byte groups.
struct alignas(16) Tri {
  float4 ce_d0;    // cross_e, d0
  float4 e1_code;  // e1, 2*sid
  float4 e2_many;  // e2, mask_any (kernel #1)
  float4 wu_mmat;  // v0 x e2, mask_mat (kernel #1)
  float4 wv_comb;  // v0 x e1, the emitter's combined mask (kernel #2)
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, cx, cy, cz;
};

// Float offset of pack row `row` inside Tri.
__device__ __forceinline__ int tri_slot(int row) {
  return row < 15 ? (row / 3) * 4 + row % 3 : (row - 15) * 4 + 3;
}

// NaN-propagating min, as torch.minimum / jnp.minimum.
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int n, int ray) {
  const size_t r = static_cast<size_t>(ray);
  const size_t ns = static_cast<size_t>(n);
  return Ray{rays[0 * ns + r], rays[1 * ns + r], rays[2 * ns + r],
             rays[3 * ns + r], rays[4 * ns + r], rays[5 * ns + r],
             rays[6 * ns + r], rays[7 * ns + r], rays[8 * ns + r]};
}

// Stage pack columns [base, base + kStage): the first kRows rows and, with
// kMaskRow, the same slice of the emitter's mask row. Every thread of the
// block must call it: it holds both barriers.
template <int kRows, bool kMaskRow>
__device__ __forceinline__ void stage_tile(Tri* stage, const float* __restrict__ pack,
                                           int n_tri_pad, int base,
                                           const float* __restrict__ mask_row) {
  float* stage_f = reinterpret_cast<float*>(stage);
  __syncthreads();  // the previous stage is no longer read
  for (int idx = threadIdx.x; idx < kRows * kStage; idx += kThreads) {
    const int row = idx / kStage;
    const int k = idx - row * kStage;
    stage_f[k * 20 + tri_slot(row)] =
        pack[static_cast<size_t>(row) * n_tri_pad + base + k];
  }
  if (kMaskRow) {
    for (int k = threadIdx.x; k < kStage; k += kThreads) {
      stage_f[k * 20 + kMaskSlot] = mask_row[base + k];
    }
  }
  __syncthreads();
}

// The pair math of _tile_step: true when the ray hits the triangle inside
// its barycentric margin at t > 1e-6; then t and the front flag are set.
__device__ __forceinline__ bool pair_hit(const Ray& r, const Tri& tri, float& t,
                                         int& front) {
  const float4 ce = tri.ce_d0;
  const float4 e1 = tri.e1_code;
  const float4 e2 = tri.e2_many;
  const float4 wu = tri.wu_mmat;
  const float4 wv = tri.wv_comb;
  // det = -(d . cross_e); t_num = o . cross_e - d0
  const float det = -(r.dx * ce.x + r.dy * ce.y + r.dz * ce.z);
  const float t_num = r.ox * ce.x + r.oy * ce.y + r.oz * ce.z - ce.w;
  // u_num = (o x d) . e2 + d . (v0 x e2)
  const float u_num = r.cx * e2.x + r.cy * e2.y + r.cz * e2.z + r.dx * wu.x +
                      r.dy * wu.y + r.dz * wu.z;
  // v_num = -((o x d) . e1) - d . (v0 x e1)
  const float v_num = -(r.cx * e1.x + r.cy * e1.y + r.cz * e1.z + r.dx * wv.x +
                        r.dy * wv.y + r.dz * wv.z);
  const float sign = det >= 0.0f ? 1.0f : -1.0f;
  const float abs_det = det * sign;
  const float un = u_num * sign;
  const float vn = v_num * sign;
  const float margin = pmin(pmin(abs_det - 1e-7f, un), pmin(vn, abs_det - (un + vn)));
  if (!(margin >= 0.0f)) return false;
  t = t_num / det;
  if (!(t > 1e-6f)) return false;
  front = det > 0.0f ? 1 : 0;
  return true;
}

// Kernel #1's eligibility: the pack's mask rows. A baked pack folds the
// primary mask (m_any when any-hits are wanted, else m_mat) into zeroed
// cross_e rows; only the other test survives (trace_cuda._mask_tests
// states the same rule for the plain version).
template <bool kTestAny, bool kTestMat>
struct PackMasks {
  __device__ __forceinline__ bool any(const Tri& tri) const {
    return !kTestAny || tri.e2_many.w > 0.0f;
  }
  __device__ __forceinline__ bool mat(const Tri& tri) const {
    return !kTestMat || tri.wu_mmat.w > 0.0f;
  }
};

// Kernel #2's eligibility: the emitter's combined row, staged in wv_comb.w.
struct CombinedMask {
  __device__ __forceinline__ bool any(const Tri& tri) const {
    return tri.wv_comb.w > 0.0f;
  }
  __device__ __forceinline__ bool mat(const Tri& tri) const {
    return tri.wv_comb.w > 1.0f;
  }
};

// One ray against every active tile, with the two-level nearest-hit fold.
// tiles_on and mask_row are uniform across the block, so every thread
// takes the same branches and reaches every barrier.
template <bool kMatrix, bool kAny, int kRows, bool kMaskRow, class Elig>
__device__ __forceinline__ void sweep_ray(const Ray& ray, const float* __restrict__ pack,
                                          int n_tri_pad, const int* __restrict__ tiles_on,
                                          int tile, const float* __restrict__ mask_row,
                                          Tri* stage, Elig elig, int& code_out,
                                          int& any_out) {
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
      stage_tile<kRows, kMaskRow>(stage, pack, n_tri_pad, base, mask_row);
#pragma unroll 2
      for (int j = 0; j < kStage; ++j) {
        float t;
        int front;
        if (!pair_hit(ray, stage[j], t, front)) continue;
        if (kAny && elig.any(stage[j])) any_hit = 1;
        if (kMatrix && elig.mat(stage[j])) {
          const int code = static_cast<int>(stage[j].e1_code.w) + front;
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
  code_out = best_t < kInf ? best_code : -1;
  any_out = any_hit;
}

template <bool kMatrix, bool kAny, bool kBaked>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ rays, int n,
             const float* __restrict__ pack, int n_tri_pad,
             const int* __restrict__ tiles_on, int tile,
             int* __restrict__ codes, int* __restrict__ any_out) {
  __shared__ Tri stage[kStage];
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < n;
  // threads past the last ray still load stages and reach every barrier
  const Ray r = load_ray(rays, n, live ? ray : 0);
  int code, any_hit;
  sweep_ray<kMatrix, kAny, kUsedRows, false>(
      r, pack, n_tri_pad, tiles_on, tile, nullptr, stage,
      PackMasks<!kBaked, !(kBaked && !kAny)>{}, code, any_hit);
  if (live) {
    codes[ray] = code;
    any_out[ray] = any_hit;
  }
}

template <bool kMatrix, bool kAny>
__global__ void __launch_bounds__(kThreads)
sweep_sched_kernel(const float* __restrict__ rays, int n,
                   const float* __restrict__ pack, int n_tri_pad,
                   const float* __restrict__ masks, int n_emit,
                   const int* __restrict__ emap, const int* __restrict__ tiles_on,
                   int tile, int* __restrict__ codes, int* __restrict__ any_out) {
  __shared__ Tri stage[kStage];
  const int ray = blockIdx.x * kThreads + threadIdx.x;  // n is a multiple of kThreads
  const int e = emap[blockIdx.x];
  if (e < 0 || e >= n_emit) {  // a row the masks do not hold sweeps nothing
    codes[ray] = -1;
    any_out[ray] = 0;
    return;
  }
  const size_t row = static_cast<size_t>(e);
  const Ray r = load_ray(rays, n, ray);
  int code, any_hit;
  sweep_ray<kMatrix, kAny, kCodeRows, true>(
      r, pack, n_tri_pad, tiles_on + row * (n_tri_pad / tile), tile,
      masks + row * n_tri_pad, stage, CombinedMask{}, code, any_hit);
  codes[ray] = code;
  any_out[ray] = any_hit;
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

template <bool kMatrix, bool kAny>
void launch_sched(const Args& a, const float* masks, int n_emit, const int* emap) {
  sweep_sched_kernel<kMatrix, kAny><<<a.n / kThreads, kThreads, 0, a.stream>>>(
      a.rays, a.n, a.pack, a.n_tri_pad, masks, n_emit, emap, a.tiles_on, a.tile,
      a.codes, a.any_out);
}

bool bad_shape(int n, int n_tri_pad, int tile, int want_matrix, int want_any) {
  return n < 0 || tile <= 0 || tile % kStage != 0 || n_tri_pad % tile != 0 ||
         !(want_matrix || want_any);
}

}  // namespace

// Launches kernel #1 on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was accepted). `tile` must be a
// multiple of 128 that divides n_tri_pad; at least one output is wanted.
extern "C" int raystrack_sweep_rays(const float* rays, int n, const float* pack,
                                    int n_tri_pad, const int* tiles_on, int tile,
                                    int want_matrix, int want_any, int masks_baked,
                                    int* codes, int* any_out, void* stream) {
  if (bad_shape(n, n_tri_pad, tile, want_matrix, want_any)) {
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

// Launches kernel #2 on `stream` without synchronising and returns
// cudaGetLastError(). n must be a multiple of 256 (one emap entry per block
// of 256 rays); masks is (n_emit, n_tri_pad) and tiles_on
// (n_emit, n_tri_pad / tile); the other rules are kernel #1's.
extern "C" int raystrack_sweep_rays_scheduled(
    const float* rays, int n, const float* pack, int n_tri_pad, const float* masks,
    int n_emit, const int* emap, const int* tiles_on, int tile, int want_matrix,
    int want_any, int* codes, int* any_out, void* stream) {
  if (bad_shape(n, n_tri_pad, tile, want_matrix, want_any) || n % kThreads != 0 ||
      n_emit < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Args a{rays, n, pack, n_tri_pad, tiles_on, tile, codes, any_out,
               static_cast<cudaStream_t>(stream)};
  if (want_matrix && want_any) {
    launch_sched<true, true>(a, masks, n_emit, emap);
  } else if (want_matrix) {
    launch_sched<true, false>(a, masks, n_emit, emap);
  } else {
    launch_sched<false, true>(a, masks, n_emit, emap);
  }
  return static_cast<int>(cudaGetLastError());
}
