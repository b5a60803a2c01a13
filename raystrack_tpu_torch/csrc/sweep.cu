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
// same eligibility they give the same bits. Kernel #1 takes a triangle's
// eligibility from the pack's mask rows, from a pack with the primary mask
// baked into zeroed cross_e rows (sweep_kernel), or, as sweep_rays' code_bounds
// mode does for a slim pack-resident scene, from the staged code row against
// two scalars (sweep_code_kernel): any-hit if code != emit_code, matrix if
// also code >= min_code. That pack is built once per scene and never
// rewritten per emitter, and only its 17 operand rows are staged.
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
// The AABB distance gate (the kGate instantiations; the TPU kernels' use_gate
// modes, _gate_need_rays / _gate_indexers): each block walks its own visit
// list of tiles (near to far from the block's mean origin, only boxes some
// ray statically crosses) and sweeps a tile only when some ray's margined
// slab interval against the tile's box can still improve its nearest hit
// or set its any-hit; __syncthreads_or is the block's vote. Where the TPU
// evaluates 16 boxes' slab tests into a bitmask per window to save a
// vector->scalar sync, a thread here tests its own ray against one box per
// step; only the window's early-exit bound is kept (__syncthreads_and). The
// TPU's split between VMEM-resident and HBM-streamed bodies is a VMEM limit:
// here every tile streams through shared memory, so a skipped tile is a
// skipped stage_tile. The gated and ungated loops share sweep_tile, so they
// run the same pair math.
//
// Exactness: built with --fmad=false and without fast math, every product
// and sum rounds as PyTorch's eager ops do and the division is IEEE, in the
// association order of _tile_step; the nearest-hit fold keeps its tie rule
// (smallest code among equal t inside a sweep tile, strictly smaller t
// across tiles). Each kernel is bitwise equal to its plain version
// (sweep_rays_reference, sweep_rays_scheduled_reference), gated or not. The
// gate is exact: a skipped tile cannot hold a hit at t <= best_t, so the
// gated result differs from the ungated one only where the visit order
// decides an exact-t tie across tiles.
//
// Layouts (see ops/trace_cuda.py): rays (9, N) f32 rows [o | d | o x d];
// pack (24, Tpad) f32 rows 0-2 cross_e, 3-5 e1, 6-8 e2, 9-11 v0 x e2,
// 12-14 v0 x e1, 15 d0, 16 2*sid, 17 mask_any, 18 mask_mat; tiles_on
// (Tpad / tile,) i32 for kernel #1, (E, Tpad / tile) i32 for kernel #2;
// masks (E, Tpad) f32 and emap (N / 256,) i32 for kernel #2; codes and any
// (N,) i32; the gate's tables as struct Gate says.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;   // rays per block, one per thread
constexpr int kStage = 128;     // triangles per shared-memory stage
constexpr int kUsedRows = 19;   // pack rows kernel #1 reads
constexpr int kCodeRows = 17;   // pack rows kernel #2 and code mode read (no mask rows)
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
// cross_e rows; only the other test survives (trace_cuda._eligibility
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

// Kernel #1's eligibility in code mode: the staged code 2*sid against the
// emitter's code and the smallest code the matrix counts (both 2*sid, exact
// in f32). Triangles of a surface the emitter's plane cull switched off stay
// eligible here: they lie behind the emission plane, so no ray can hit them,
// and whole tiles of them still drop out through tiles_on.
struct CodeBounds {
  float emit_code;
  float min_code;
  __device__ __forceinline__ bool any(const Tri& tri) const {
    return tri.e1_code.w != emit_code;
  }
  __device__ __forceinline__ bool mat(const Tri& tri) const {
    return tri.e1_code.w != emit_code && tri.e1_code.w >= min_code;
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

// The gate's per-call tables (ops/trace_cuda.py _gate_tables). Block b
// visits positions j < counts[b] * group: box order[b][j / group], tile
// box * group + j % group (tiles_on is padded with inactive phantom tiles
// up to whole groups). With window > 0, at j % window == 0 the block stops
// once every ray's best_t <= suffmin[b][j / window] (and any_hit is set,
// when wanted).
struct Gate {
  const float* boxes;    // (n_boxes, 6): lo_x, lo_y, lo_z, hi_x, hi_y, hi_z
  const int* order;      // (n_blocks, n_boxes)
  const int* counts;     // (n_blocks,)
  const float* suffmin;  // (n_blocks, n_windows)
  int n_boxes;
  int group;
  int window;
  int n_windows;
};

// NaN-propagating max, as torch.maximum / jnp.maximum.
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The ray terms of the slab test, computed once per thread (_ray_inv).
struct RayInv {
  float inv[3];
  bool zero[3];
  bool pos[3];
};

__device__ __forceinline__ RayInv ray_inv(const Ray& r) {
  const float d[3] = {r.dx, r.dy, r.dz};
  RayInv v;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v.zero[c] = fabsf(d[c]) <= 1e-30f;
    v.inv[c] = 1.0f / (v.zero[c] ? 1.0f : d[c]);
    v.pos[c] = d[c] >= 0.0f;
  }
  return v;
}

// Whether this ray still needs the tile under `box` (_gate_need_rays):
// its margined slab interval crosses the box and starts before its
// nearest hit, or it crosses it and has no any-hit yet. The margins keep
// the test conservative, so skipping a tile no ray of the block needs is
// exact. The op order is the plain version's (trace_cuda._box_interval).
template <bool kMatrix, bool kAny>
__device__ __forceinline__ bool box_needed(const Ray& r, const RayInv& v,
                                           const float* __restrict__ box, float best_t,
                                           int any_hit) {
  const float o[3] = {r.ox, r.oy, r.oz};
  float near = 0.0f, far = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lo = box[c];
    const float hi = box[3 + c];
    float t_n, t_f;
    if (v.zero[c]) {
      const bool inside = o[c] >= lo && o[c] <= hi;
      t_n = inside ? -kInf : kInf;
      t_f = inside ? kInf : -kInf;
    } else {
      t_n = ((v.pos[c] ? lo : hi) - o[c]) * v.inv[c];
      t_f = ((v.pos[c] ? hi : lo) - o[c]) * v.inv[c];
    }
    near = c == 0 ? t_n : pmax(near, t_n);
    far = c == 0 ? t_f : pmin(far, t_f);
  }
  const float near_c = near - (fabsf(near) * 1e-4f + 1e-6f);
  const float far_c = far + (fabsf(far) * 1e-4f + 1e-6f);
  const bool hit_box = far_c >= near_c && far_c > 1e-6f;
  bool need = false;
  if (kMatrix) need = hit_box && near_c < best_t;
  if (kAny) need = need || (hit_box && any_hit == 0);
  return need;
}

// One sweep tile of one ray, staged kStage triangles at a time, folded into
// the ray's carry with the tile-level tie rule. Every thread of the block
// must call it: stage_tile holds barriers.
template <bool kMatrix, bool kAny, int kRows, bool kMaskRow, class Elig>
__device__ __forceinline__ void sweep_tile(const Ray& ray, const float* __restrict__ pack,
                                           int n_tri_pad, int it, int tile,
                                           const float* __restrict__ mask_row, Tri* stage,
                                           Elig elig, float& best_t, int& best_code,
                                           int& any_hit) {
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

// One ray against the scene. Ungated: every active tile in order. Gated:
// the block's visit list, each tile taken only when some live ray of the
// block needs it (__syncthreads_or: one instruction for the TPU's any-reduce
// over the block) and the list cut short at window starts once every ray
// is settled (__syncthreads_and). tiles_on, the visit list and both votes
// are uniform across the block, so every thread takes the same branches
// and reaches every barrier; threads past the last ray vote "not needed"
// and "settled". Thread 0 writes the block's count of swept tiles to
// `visits` when it is given.
template <bool kMatrix, bool kAny, bool kGate, int kRows, bool kMaskRow, class Elig>
__device__ __forceinline__ void sweep_ray(const Ray& ray, bool live,
                                          const float* __restrict__ pack, int n_tri_pad,
                                          const int* __restrict__ tiles_on, int tile,
                                          const float* __restrict__ mask_row,
                                          const Gate& gate, Tri* stage, Elig elig,
                                          int& code_out, int& any_out,
                                          int* __restrict__ visits) {
  float best_t = kInf;
  int best_code = -1;
  int any_hit = 0;
  int n_swept = 0;
  if (!kGate) {
    const int n_tiles = n_tri_pad / tile;
    for (int it = 0; it < n_tiles; ++it) {
      if (tiles_on[it] == 0) continue;  // no eligible triangle: exact skip
      sweep_tile<kMatrix, kAny, kRows, kMaskRow>(ray, pack, n_tri_pad, it, tile, mask_row,
                                                 stage, elig, best_t, best_code, any_hit);
      ++n_swept;
    }
  } else {
    const RayInv inv = ray_inv(ray);
    const size_t b = blockIdx.x;
    const int* __restrict__ order = gate.order + b * gate.n_boxes;
    const int n_visit = gate.counts[b] * gate.group;
    for (int j = 0; j < n_visit; ++j) {
      if (gate.window > 0 && j % gate.window == 0) {
        const float bound = gate.suffmin[b * gate.n_windows + j / gate.window];
        const bool settled = !live || (best_t <= bound && (!kAny || any_hit != 0));
        if (__syncthreads_and(settled)) break;  // no later box can pass
      }
      const int box = order[j / gate.group];
      const int it = box * gate.group + j % gate.group;
      if (tiles_on[it] == 0) continue;
      const bool need =
          live && box_needed<kMatrix, kAny>(ray, inv, gate.boxes + 6 * box, best_t, any_hit);
      if (!__syncthreads_or(need)) continue;  // no ray can improve: exact skip
      sweep_tile<kMatrix, kAny, kRows, kMaskRow>(ray, pack, n_tri_pad, it, tile, mask_row,
                                                 stage, elig, best_t, best_code, any_hit);
      ++n_swept;
    }
  }
  if (visits != nullptr && threadIdx.x == 0) visits[blockIdx.x] = n_swept;
  code_out = best_t < kInf ? best_code : -1;
  any_out = any_hit;
}

template <bool kMatrix, bool kAny, bool kBaked, bool kGate>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ rays, int n,
             const float* __restrict__ pack, int n_tri_pad,
             const int* __restrict__ tiles_on, int tile, Gate gate,
             int* __restrict__ codes, int* __restrict__ any_out,
             int* __restrict__ visits) {
  __shared__ Tri stage[kStage];
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < n;
  // threads past the last ray still load stages and reach every barrier
  const Ray r = load_ray(rays, n, live ? ray : 0);
  int code, any_hit;
  sweep_ray<kMatrix, kAny, kGate, kUsedRows, false>(
      r, live, pack, n_tri_pad, tiles_on, tile, nullptr, gate, stage,
      PackMasks<!kBaked, !(kBaked && !kAny)>{}, code, any_hit, visits);
  if (live) {
    codes[ray] = code;
    any_out[ray] = any_hit;
  }
}

template <bool kMatrix, bool kAny, bool kGate>
__global__ void __launch_bounds__(kThreads)
sweep_code_kernel(const float* __restrict__ rays, int n,
                  const float* __restrict__ pack, int n_tri_pad,
                  const int* __restrict__ tiles_on, int tile, float emit_code,
                  float min_code, Gate gate, int* __restrict__ codes,
                  int* __restrict__ any_out, int* __restrict__ visits) {
  __shared__ Tri stage[kStage];
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < n;
  const Ray r = load_ray(rays, n, live ? ray : 0);
  int code, any_hit;
  sweep_ray<kMatrix, kAny, kGate, kCodeRows, false>(
      r, live, pack, n_tri_pad, tiles_on, tile, nullptr, gate, stage,
      CodeBounds{emit_code, min_code}, code, any_hit, visits);
  if (live) {
    codes[ray] = code;
    any_out[ray] = any_hit;
  }
}

template <bool kMatrix, bool kAny, bool kGate>
__global__ void __launch_bounds__(kThreads)
sweep_sched_kernel(const float* __restrict__ rays, int n,
                   const float* __restrict__ pack, int n_tri_pad,
                   const float* __restrict__ masks, int n_emit,
                   const int* __restrict__ emap, const int* __restrict__ tiles_on,
                   int tiles_stride, int tile, Gate gate, int* __restrict__ codes,
                   int* __restrict__ any_out, int* __restrict__ visits) {
  __shared__ Tri stage[kStage];
  const int ray = blockIdx.x * kThreads + threadIdx.x;  // n is a multiple of kThreads
  const int e = emap[blockIdx.x];
  if (e < 0 || e >= n_emit) {  // a row the masks do not hold sweeps nothing;
    codes[ray] = -1;           // block-uniform, and before any barrier
    any_out[ray] = 0;
    if (visits != nullptr && threadIdx.x == 0) visits[blockIdx.x] = 0;
    return;
  }
  const size_t row = static_cast<size_t>(e);
  const Ray r = load_ray(rays, n, ray);
  int code, any_hit;
  sweep_ray<kMatrix, kAny, kGate, kCodeRows, true>(
      r, true, pack, n_tri_pad, tiles_on + row * tiles_stride, tile,
      masks + row * n_tri_pad, gate, stage, CombinedMask{}, code, any_hit, visits);
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
  Gate gate;
  int* codes;
  int* any_out;
  int* visits;
  cudaStream_t stream;
};

// Kernel #1's mask modes, in the order of ops/trace_cuda.py _MASK_MODES.
enum MaskMode { kRowsMode = 0, kBakedMode = 1, kCodeMode = 2 };

struct Masks {
  int mode;
  float emit_code;  // code mode only
  float min_code;
};

template <bool kMatrix, bool kAny, bool kGate>
void launch(const Masks& m, const Args& a) {
  const dim3 grid((a.n + kThreads - 1) / kThreads);
  if (m.mode == kCodeMode) {
    sweep_code_kernel<kMatrix, kAny, kGate><<<grid, kThreads, 0, a.stream>>>(
        a.rays, a.n, a.pack, a.n_tri_pad, a.tiles_on, a.tile, m.emit_code, m.min_code,
        a.gate, a.codes, a.any_out, a.visits);
  } else if (m.mode == kBakedMode) {
    sweep_kernel<kMatrix, kAny, true, kGate><<<grid, kThreads, 0, a.stream>>>(
        a.rays, a.n, a.pack, a.n_tri_pad, a.tiles_on, a.tile, a.gate, a.codes, a.any_out,
        a.visits);
  } else {
    sweep_kernel<kMatrix, kAny, false, kGate><<<grid, kThreads, 0, a.stream>>>(
        a.rays, a.n, a.pack, a.n_tri_pad, a.tiles_on, a.tile, a.gate, a.codes, a.any_out,
        a.visits);
  }
}

template <bool kMatrix, bool kAny>
void launch_outputs(const Masks& m, bool gated, const Args& a) {
  if (gated) {
    launch<kMatrix, kAny, true>(m, a);
  } else {
    launch<kMatrix, kAny, false>(m, a);
  }
}

template <bool kMatrix, bool kAny, bool kGate>
void launch_sched(const Args& a, const float* masks, int n_emit, const int* emap,
                  int tiles_stride) {
  sweep_sched_kernel<kMatrix, kAny, kGate><<<a.n / kThreads, kThreads, 0, a.stream>>>(
      a.rays, a.n, a.pack, a.n_tri_pad, masks, n_emit, emap, a.tiles_on, tiles_stride,
      a.tile, a.gate, a.codes, a.any_out, a.visits);
}

template <bool kMatrix, bool kAny>
void launch_sched_outputs(bool gated, const Args& a, const float* masks, int n_emit,
                          const int* emap, int tiles_stride) {
  if (gated) {
    launch_sched<kMatrix, kAny, true>(a, masks, n_emit, emap, tiles_stride);
  } else {
    launch_sched<kMatrix, kAny, false>(a, masks, n_emit, emap, tiles_stride);
  }
}

bool bad_shape(int n, int n_tri_pad, int tile, int want_matrix, int want_any) {
  return n < 0 || tile <= 0 || tile % kStage != 0 || n_tri_pad % tile != 0 ||
         !(want_matrix || want_any);
}

// A gate is given when `order` is not NULL; then all its tables must be.
bool bad_gate(const Gate& g) {
  if (g.order == nullptr) return false;
  return g.boxes == nullptr || g.counts == nullptr || g.n_boxes <= 0 || g.group < 1 ||
         g.window < 0 || (g.window > 0 && (g.suffmin == nullptr ||
                                           g.n_windows * g.window < g.n_boxes));
}

}  // namespace

// Launches kernel #1 on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was accepted). `tile` must be a
// multiple of 128 that divides n_tri_pad; at least one output is wanted.
// mask_mode is 0 (the pack's mask rows), 1 (a baked pack) or 2 (the pack's
// code row against emit_code and min_code, which the other modes ignore).
// With a gate (`order` not NULL) the tables are those of ops/trace_cuda.py
// _gate_tables for these rays: one row per block of 256 rays, and tiles_on
// padded to whole groups. `visits` (NULL, or one int per block) receives
// each block's count of swept tiles.
extern "C" int raystrack_sweep_rays(const float* rays, int n, const float* pack,
                                    int n_tri_pad, const int* tiles_on, int tile,
                                    int want_matrix, int want_any, int mask_mode,
                                    float emit_code, float min_code, const float* boxes, const int* order, const int* counts,
                                    const float* suffmin, int n_boxes, int group,
                                    int window, int n_windows, int* codes, int* any_out,
                                    int* visits, void* stream) {
  const Gate gate{boxes, order, counts, suffmin, n_boxes, group, window, n_windows};
  if (bad_shape(n, n_tri_pad, tile, want_matrix, want_any) || bad_gate(gate) ||
      mask_mode < kRowsMode || mask_mode > kCodeMode) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Args a{rays, n, pack, n_tri_pad, tiles_on, tile, gate, codes, any_out, visits,
               static_cast<cudaStream_t>(stream)};
  const Masks m{mask_mode, emit_code, min_code};
  const bool gated = order != nullptr;
  if (want_matrix && want_any) {
    launch_outputs<true, true>(m, gated, a);
  } else if (want_matrix) {
    launch_outputs<true, false>(m, gated, a);
  } else {
    launch_outputs<false, true>(m, gated, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches kernel #2 on `stream` without synchronising and returns
// cudaGetLastError(). n must be a multiple of 256 (one emap entry per block
// of 256 rays); masks is (n_emit, n_tri_pad) and tiles_on (n_emit,
// tiles_stride), tiles_stride >= n_tri_pad / tile; the other rules are
// kernel #1's.
extern "C" int raystrack_sweep_rays_scheduled(
    const float* rays, int n, const float* pack, int n_tri_pad, const float* masks,
    int n_emit, const int* emap, const int* tiles_on, int tiles_stride, int tile,
    int want_matrix, int want_any, const float* boxes, const int* order,
    const int* counts, const float* suffmin, int n_boxes, int group, int window,
    int n_windows, int* codes, int* any_out, int* visits, void* stream) {
  const Gate gate{boxes, order, counts, suffmin, n_boxes, group, window, n_windows};
  if (bad_shape(n, n_tri_pad, tile, want_matrix, want_any) || bad_gate(gate) ||
      n % kThreads != 0 || n_emit < 0 || tiles_stride < n_tri_pad / tile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Args a{rays, n, pack, n_tri_pad, tiles_on, tile, gate, codes, any_out, visits,
               static_cast<cudaStream_t>(stream)};
  const bool gated = order != nullptr;
  if (want_matrix && want_any) {
    launch_sched_outputs<true, true>(gated, a, masks, n_emit, emap, tiles_stride);
  } else if (want_matrix) {
    launch_sched_outputs<true, false>(gated, a, masks, n_emit, emap, tiles_stride);
  } else {
    launch_sched_outputs<false, true>(gated, a, masks, n_emit, emap, tiles_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
