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
// functions stage_async, pair_margin, pair_t and sweep_ray, so on the same
// rays and the same eligibility they give the same bits. Kernel #1 takes a triangle's
// eligibility from the pack's mask rows, from a pack with the primary mask
// baked into zeroed cross_e rows (sweep_kernel), or, as sweep_rays' code_bounds
// mode does for a slim pack-resident scene, from the staged code row against
// two scalars (sweep_code_kernel): any-hit if code != emit_code, matrix if
// also code >= min_code. That pack is built once per scene and never
// rewritten per emitter, and only its 17 operand rows are staged.
//
// What bounds them: FP32 ALU work. A ray-triangle pair that fails the
// margin test costs 45-46 FP32 instructions in the SASS of every
// instantiation, 55-61 instructions in all (chip_smoke.py counts them from
// the library at every run; 51 and 64-66 while every pair worked out t_num
// and one ray a thread read the triangle alone); a triangle's operands are
// 76 bytes, read once per block of rays. So each block stages a tile of
// triangle operands in shared memory (coalesced loads along the pack's
// triangle axis) and every thread loops over staged triangles reading the
// operands as broadcast 16-byte loads. Kernel #2
// stages its emitter's mask row slice in the same stage, in the slot kernel
// #1 leaves unused, so the per-pair mask test costs one shared load. The
// t = t_num / det division runs only for pairs whose barycentric tests pass.
// A Hopper scheduler issues one warp instruction a clock, so every shared
// load, branch and loop instruction takes a slot the FP32 work needs; three
// measures keep them off the pair loop:
//
// - Rays a thread (kR in {1, 4}): a thread holds kR rays, each with its
//   own operands and carry, reads a staged triangle once (five LDS.128) and
//   tests it against all kR, so the loads, the loop's bookkeeping and the
//   eligibility reads are paid once per kR pairs, and the kR independent
//   chains give a warp the parallelism a CTA alone on its SM lacks. Each
//   ray's arithmetic is pair_margin's and pair_t's, in _tile_step's order,
//   so its bits do not change; thread = part * (kCta / kR) + g serves rays
//   g + q * (kCta / kR), q < kR, so a warp's loads of rays and stores of
//   results stay coalesced.
// - The margin test first: nearly every pair fails the barycentric margin,
//   so a thread tests its kR rays' margins against a staged triangle
//   (pair_margin) and takes one branch a triangle; t_num, the division and
//   the eligibility are worked out only behind it (pair_t), from the same
//   operands in the same order.
// - A double-buffered stage: stage s + 1 is copied into the second buffer
//   with 4-byte cp.async (the Tri layout's slots are not 16-byte runs of one
//   pack row) while stage s is swept; one barrier a stage, after
//   cp.async.wait_group, where a synchronous stage needed two and left the
//   loads' latency bare on an SM that holds one CTA. Ungated, the next
//   active tile's first stage is copied during the last stage of the tile
//   before; gated, the next tile is known only after the vote, so its first
//   stage is copied then.
//
// Kernel #2 reads its tile table from global memory at every size: the
// TPU's union fallback past SCHED_TILES_SMEM_BUDGET is a limit of its scalar
// memory that this card does not have.
//
// The triangle split (kSplit in {1, 2, 4, 8, 16}): kSplit threads serve one
// ray, so a CTA is kCta rays x kSplit threads / kR rays a thread. The TPU kernel has no such
// choice: its grid runs in order on one core. On this card a launch of few
// ray blocks, or a gated launch whose blocks sweep between 0 and 124 tiles,
// leaves SMs with one block of 8 warps or none, and a block of rays that
// crosses the whole scene sweeps hundreds of tiles on one SM: the split
// lets such a block use the whole width of its SM (one block alone on an
// SM sweeps 48 tiles in 14.66 ms at one thread a ray and in 7.43 ms at
// four). The kSplit threads of a ray sit in different warps (thread = part
// * kCta / kR + g), so each warp still reads one staged triangle at a time as
// a broadcast, without bank conflicts of the 80-byte Tri stride; within
// every 128-triangle stage, part p takes triangles
// [p * 128 / kSplit, (p + 1) * 128 / kSplit). At the end of a sweep
// tile the parts' (t, code, any-hit) meet in shared memory and every thread
// of the ray merges all of them by the rule the tile already has: smaller t,
// and among equal t the smaller code; OR for the any-hit. Inside a tile that
// rule is a minimum over the tile's triangles in the order (t, code), which
// does not depend on how they are partitioned or visited, so the merged
// result is bitwise the unsplit one. The fold across tiles (strictly
// smaller t replaces the carry), whose order does matter, is untouched, and
// since every thread of a ray holds the same carry, every thread casts the
// same vote.
//
// The CTA and the gate block (kCta in {64, 128, 256}): a gate block stays
// 256 rays, because the gate's tables (one row per block), emap and the JAX
// package's ray_block are defined on it; a CTA serves kCta of its rays
// (CTA c serves rays [c * kCta, (c + 1) * kCta) of block c * kCta / 256)
// and walks that block's visit list with its own votes over its own rays.
// That is exact: for one ray the walk returns the minimum, in the order (t,
// visit position, code), over the hits inside the boxes the ray crosses; a
// tile no ray of the CTA needs holds no hit below any of their carries, so
// by induction every ray keeps the carry the 256-ray walk gives it, the
// CTAs of a block together sweep exactly the tiles the block's walk sweeps,
// and suffmin, a bound over the block's rays, bounds any subset of them.
// What it buys: a whole block a CTA at 4 threads a ray is 1,024 threads,
// one to an SM, so a launch of 192 blocks on 132 SMs runs in two waves for
// 1.45 waves of work and lasts as long as the SM that drew its heaviest
// blocks, while a CTA of part of a block spreads a block's work over
// several SMs. The geometries built are sweep.cuh's
// RAYSTRACK_SWEEP_GEOMETRIES, one translation unit each
// (sweep_<kCta>x<kSplit>[r<kR>][_gated].cu); the wrapper picks one from the
// launch's shape (ops/trace_cuda.py sweep_split, with the measured table
// behind it). At one thread a ray the kernel is the unsplit one: its
// shared block is the stage alone and its part and ray indices are
// constants.
//
// Tile segments (ungated launches; struct Segments, sweep.cuh): a block's
// tiles cut into `count` contiguous runs, each swept by a CTA of its own
// from a fresh carry, so a launch of few whole-block CTAs of 1,024 threads
// fills every SM's slot with its last wave as full as the count can make
// it. The segments' (best t, code, any-hit) fold in segment order by the
// carry's own rule (sweep.cu sweep_fold_kernel): ungated, the walk's fold
// runs in tile order, so the result is the one-segment walk's bit for bit.
// A gated walk is not cut: a later segment would start without the carry
// its votes need (the plain versions measure what that costs).

//
// The AABB distance gate (the kGate instantiations; the TPU kernels' use_gate
// modes, _gate_need_rays / _gate_indexers): each block walks its own visit
// list of tiles (near to far from the block's mean origin, only boxes some
// ray statically crosses) and sweeps a tile only when some ray's margined
// slab interval against the tile's box can still improve its nearest hit
// or set its any-hit; __syncthreads_or is the block's vote. Where the TPU
// evaluates 16 boxes' slab tests into a bitmask per window to save a
// vector->scalar sync, a thread here tests its own ray against one box per
// step; only the window's early-exit bound is kept (__syncthreads_and).
// About a quarter of the positions a block walks end at the vote (13,288 of
// 55,382 on a 262,144-ray chunk of the 1M-triangle city: the visit list holds
// only crossed boxes and ends early), and the list is read ahead for them:
// 130 threads load the next 16 positions' box indices, boxes, tile flags and
// early-exit bounds from global memory while the block works through the
// current 16, and park them in shared memory, so a visit that ends at the
// vote costs a slab test on shared operands and one barrier. The TPU's
// split between VMEM-resident and HBM-streamed bodies is a VMEM limit: here
// every tile streams through shared memory, so a skipped tile is a skipped
// stage_tile.
// The gated and ungated loops share sweep_tile, so they run the same pair
// math.
//
// Exactness: built with --fmad=false and without fast math, every product
// and sum rounds as PyTorch's eager ops do and the division is IEEE, in the
// association order of _tile_step; the nearest-hit fold keeps its tie rule
// (smallest code among equal t inside a sweep tile, strictly smaller t
// across tiles). Each kernel is bitwise equal to its plain version
// (sweep_rays_reference, sweep_rays_scheduled_reference), gated or not, at
// every split. The gate is exact: a skipped tile
// cannot hold a hit at t <= best_t, so the gated result differs from the
// ungated one only where the visit order decides an exact-t tie across tiles.
//
// Layouts (see ops/trace_cuda.py): rays (9, N) f32 rows [o | d | o x d];
// pack (24, Tpad) f32 rows 0-2 cross_e, 3-5 e1, 6-8 e2, 9-11 v0 x e2,
// 12-14 v0 x e1, 15 d0, 16 2*sid, 17 mask_any, 18 mask_mat; tiles_on
// (Tpad / tile,) i32 for kernel #1, (E, Tpad / tile) i32 for kernel #2;
// masks (E, Tpad) f32 and emap (N / 256,) i32 for kernel #2; codes and any
// (N,) i32; the gate's tables as struct Gate says (sweep.cuh).
#pragma once

#include <cstddef>

#include "gate.cuh"
#include "sweep.cuh"

namespace raystrack {
namespace {

constexpr int kRays = 256;      // rays per gate block: one emap entry, one gate-table row
constexpr int kStage = 128;     // triangles per shared-memory stage
constexpr int kUsedRows = 19;   // pack rows kernel #1 reads
constexpr int kCodeRows = 17;   // pack rows kernel #2 and code mode read (no mask rows)
constexpr int kMaskSlot = 19;   // Tri float slot of kernel #2's mask row
constexpr int kAhead = 16;      // visit-list positions read ahead at a time
constexpr int kAheadWords = 8;  // per position: six box floats, tile flag, box index
constexpr int kAheadThreads = kAhead * kAheadWords + 2;  // the read-ahead's loads and bounds

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

// A CTA's threads: kCta rays x kSplit threads a ray / kR rays a thread.
// Thread = part * kGroups + g serves rays g + q * kGroups (q < kR) of the
// CTA and takes part `part` of every stage. Constants at one thread a ray.
template <int kSplit, int kCta, int kR>
struct Layout {
  static constexpr int kGroups = kCta / kR;  // the threads of one part
  static constexpr int kThreads = kGroups * kSplit;
  static_assert(kCta % kR == 0 && kThreads % kStage == 0,
                "a stage's copy gives each thread whole pack rows of one column");
  __device__ static int part() {
    return kSplit == 1 ? 0 : static_cast<int>(threadIdx.x) / kGroups;
  }
  __device__ static int ray(int q) {
    return (kSplit == 1 ? static_cast<int>(threadIdx.x) : static_cast<int>(threadIdx.x) % kGroups)
           + q * kGroups;
  }
};

// A CTA's shared memory: the two stage buffers; at more than one thread a
// ray, the parts' results of a split tile; in a gated CTA, the read-ahead
// (two buffers of kAhead positions). What an instantiation does not use is
// an empty base: an ungated CTA at one thread a ray holds the 20,480 bytes
// of its stages and nothing else. CUDA sizes the carve-out for the
// resident CTAs and leaves the rest of the SM's 256 KB to the L1 cache,
// through which the CTAs share the pack.
template <int kSplit, int kCta>
struct Parts {
  float part_t[kSplit * kCta];
  int part_code[kSplit * kCta];
  int part_any[kSplit * kCta];
};
template <int kCta>
struct Parts<1, kCta> {};

template <bool kGate>
struct Ahead {
  alignas(16) unsigned ahead[2][kAhead][kAheadWords];
  float bound[2][2];  // early-exit bounds of the windows inside kAhead positions
};
template <>
struct Ahead<false> {};

template <int kSplit, int kCta, bool kGate>
struct Shared : Parts<kSplit, kCta>, Ahead<kGate> {
  Tri stage[2][kStage];
};

// The gate block of 256 rays that CTA `cta` (of kCta rays) serves.
template <int kCta>
__device__ __forceinline__ size_t cta_block(int cta) {
  return static_cast<size_t>(cta) / (kRays / kCta);
}

// Which CTA of kCta rays (ray group) and which tile segment this block of
// threads serves: blockIdx.x = group * segments + segment. Gated launches
// have one segment.
template <bool kGate>
__device__ __forceinline__ int2 cta_place(const Segments& seg) {
  if (kGate || seg.count == 1) return make_int2(blockIdx.x, 0);
  return make_int2(blockIdx.x / seg.count, blockIdx.x % seg.count);
}

// Float offset of pack row `row` inside Tri.
__device__ __forceinline__ int tri_slot(int row) {
  return row < 15 ? (row / 3) * 4 + row % 3 : (row - 15) * 4 + 3;
}

// Nanoseconds of the card's global timer, and the SM this block runs on.
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int sm_id() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int n, int ray) {
  const size_t r = static_cast<size_t>(ray);
  const size_t ns = static_cast<size_t>(n);
  return Ray{rays[0 * ns + r], rays[1 * ns + r], rays[2 * ns + r],
             rays[3 * ns + r], rays[4 * ns + r], rays[5 * ns + r],
             rays[6 * ns + r], rays[7 * ns + r], rays[8 * ns + r]};
}

// One float from global to shared memory through cp.async (cached in L1,
// as the pack's loads were); cp_async_commit closes this thread's group of
// them, cp_async_wait waits for all of its groups.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Start copying pack columns [base, base + kStage) into `stage`: the first
// kRows rows and, with kMaskRow, the same slice of the emitter's mask row.
// Thread t copies column t % kStage of rows t / kStage, t / kStage +
// kThreads / kStage, ... (coalesced along the pack's triangle axis). The
// caller waits (cp_async_wait, then a barrier) before the stage is read,
// and issues it only once every thread has finished reading the buffer.
template <int kRows, bool kMaskRow, int kThreads>
__device__ __forceinline__ void stage_async(Tri* stage, const float* __restrict__ pack,
                                            int n_tri_pad, int base,
                                            const float* __restrict__ mask_row) {
  const int k = static_cast<int>(threadIdx.x) % kStage;
  float* dst = reinterpret_cast<float*>(stage + k);
  const float* src = pack + base + k;
#pragma unroll
  for (int row = static_cast<int>(threadIdx.x) / kStage; row < kRows; row += kThreads / kStage) {
    cp_async4(dst + tri_slot(row), src + static_cast<size_t>(row) * n_tri_pad);
  }
  if (kMaskRow && threadIdx.x < kStage) cp_async4(dst + kMaskSlot, mask_row + base + k);
  cp_async_commit();
}

// The pair math of _tile_step, in two parts. pair_margin: whether the ray
// meets the triangle inside its barycentric margin (|det| >= 1e-7 and both
// barycentrics in range), the test nearly every pair fails. pair_t, only
// for a pair that passed it: t = t_num / det and the front flag, true when
// t > 1e-6. pair_t works det and t_num out anew in the same operations and
// order (so the same bits) from the staged triangle read through a volatile
// pointer: the compiler can neither hoist those loads, and the arithmetic
// on them, above the margin test nor keep det alive across it, so the
// pairs that fail it pay for neither t_num nor the division.
__device__ __forceinline__ bool pair_margin(const Ray& r, const Tri& tri) {
  const float4 ce = tri.ce_d0;
  const float4 e1 = tri.e1_code;
  const float4 e2 = tri.e2_many;
  const float4 wu = tri.wu_mmat;
  const float4 wv = tri.wv_comb;
  // det = -(d . cross_e)
  const float det = -(r.dx * ce.x + r.dy * ce.y + r.dz * ce.z);
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
  return margin >= 0.0f;
}

__device__ __forceinline__ bool pair_t(const Ray& r, const Tri& tri, float& t, int& front) {
  const volatile float* ce = &tri.ce_d0.x;  // cross_e, d0
  const float cx = ce[0], cy = ce[1], cz = ce[2], d0 = ce[3];
  // det = -(d . cross_e); t_num = o . cross_e - d0
  const float det = -(r.dx * cx + r.dy * cy + r.dz * cz);
  const float t_num = r.ox * cx + r.oy * cy + r.oz * cz - d0;
  // the IEEE division a plain `/` compiles to, written as PTX: the
  // compiler does not speculate an asm statement
  asm("div.rn.f32 %0, %1, %2;" : "=f"(t) : "f"(t_num), "f"(det));
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

// Whether this ray still needs the tile under `box` (_gate_need_rays):
// its margined slab interval crosses the box and starts before its
// nearest hit, or it crosses it and has no any-hit yet. The margins keep
// the test conservative, so skipping a tile no ray of the block needs is
// exact. `box` is six floats of the read-ahead in shared memory. The ray's
// reciprocal direction is worked out anew at every visit: three divisions
// beside the hundred thousand instructions of a swept tile, and no
// registers held for them across the sweep.
template <bool kMatrix, bool kAny>
__device__ __forceinline__ bool box_needed(const Ray& r, const float* box, float best_t,
                                           int any_hit) {
  const RayInv v = ray_inv(r.dx, r.dy, r.dz);
  const float o[3] = {r.ox, r.oy, r.oz};
  const float lo[3] = {box[0], box[1], box[2]};
  const float hi[3] = {box[3], box[4], box[5]};
  float near_c, far_c;
  slab_interval(o, v, lo, hi, near_c, far_c);
  const bool hit_box = slab_hit(near_c, far_c);
  bool need = false;
  if (kMatrix) need = hit_box && near_c < best_t;
  if (kAny) need = need || (hit_box && any_hit == 0);
  return need;
}

// A thread's kR rays and their carries (best t, code, any-hit), which all
// threads of a ray keep alike.
template <int kR>
struct Carry {
  Ray ray[kR];
  bool live[kR];
  float best_t[kR];
  int best_code[kR];
  int any_hit[kR];
};

// One sweep tile of the thread's kR rays, kStage triangles a stage, each of
// a ray's kSplit threads taking its part of every stage; the parts merged by
// the tile's own tie rule, the result folded into the rays' carries. On
// entry the tile's first stage has been issued into sh.stage[buf]; during
// its last stage the first stage of tile `next` (unless -1) is issued into
// the other buffer, and `buf` names the buffer of the next stage to sweep.
// Every thread of the CTA must call it: the stages and the merge hold
// barriers.
template <bool kMatrix, bool kAny, int kRows, bool kMaskRow, int kSplit, int kCta, int kR,
          class Sh, class Elig>
__device__ __forceinline__ void sweep_tile(Carry<kR>& c, const float* __restrict__ pack,
                                           int n_tri_pad, int it, int next, int tile,
                                           const float* __restrict__ mask_row, Sh& sh, int& buf,
                                           Elig elig) {
  using L = Layout<kSplit, kCta, kR>;
  constexpr int kPart = kStage / kSplit;
  const int off = L::part() * kPart;
  float tile_t[kR];
  int tile_code[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    tile_t[q] = kInf;
    tile_code[q] = 1 << 30;
  }
  const int n_stages = tile / kStage;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait();  // this thread's share of stage s has landed
    __syncthreads();  // every share has landed, and the other buffer is no longer read
    const int ahead = s + 1 < n_stages ? it * tile + (s + 1) * kStage
                                       : (next >= 0 ? next * tile : -1);
    if (ahead >= 0) {
      stage_async<kRows, kMaskRow, L::kThreads>(sh.stage[buf ^ 1], pack, n_tri_pad, ahead,
                                                mask_row);
    }
    const Tri* mine = sh.stage[buf] + off;
    buf ^= 1;
#pragma unroll 2
    for (int j = 0; j < kPart; ++j) {
      const Tri tri = mine[j];
      bool inside[kR];
      bool any_inside = false;
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        inside[q] = pair_margin(c.ray[q], tri);
        any_inside = any_inside || inside[q];
      }
      if (!any_inside) continue;  // one branch a triangle, nearly always taken
      // the rare pairs inside the margin: t, the eligibility and the code,
      // read again from shared memory (from the registers, the compares
      // were hoisted above the branch and every pair paid for them)
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        float t;
        int front;
        if (!inside[q] || !pair_t(c.ray[q], mine[j], t, front)) continue;
        if (kAny && elig.any(mine[j])) c.any_hit[q] = 1;
        if (kMatrix && elig.mat(mine[j])) {
          const int code = static_cast<int>(mine[j].e1_code.w) + front;
          if (t < tile_t[q]) {
            tile_t[q] = t;
            tile_code[q] = code;
          } else if (t == tile_t[q] && code < tile_code[q]) {
            tile_code[q] = code;
          }
        }
      }
    }
  }
  if constexpr (kSplit > 1) {
    // the next write of these slots comes after the next stage's barrier
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const int at = L::part() * kCta + L::ray(q);
      if (kMatrix) {
        sh.part_t[at] = tile_t[q];
        sh.part_code[at] = tile_code[q];
      }
      if (kAny) sh.part_any[at] = c.any_hit[q];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const int r = L::ray(q);
      tile_t[q] = kInf;
      tile_code[q] = 1 << 30;
#pragma unroll
      for (int p = 0; p < kSplit; ++p) {
        if (kMatrix) {
          const float t = sh.part_t[p * kCta + r];
          const int code = sh.part_code[p * kCta + r];
          if (t < tile_t[q]) {
            tile_t[q] = t;
            tile_code[q] = code;
          } else if (t == tile_t[q] && code < tile_code[q]) {
            tile_code[q] = code;
          }
        }
        if (kAny) c.any_hit[q] |= sh.part_any[p * kCta + r];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    if (kMatrix && tile_t[q] < c.best_t[q]) {
      c.best_t[q] = tile_t[q];
      c.best_code[q] = tile_code[q];
    }
  }
}

// The gate's read-ahead. ahead_load starts this thread's global load for
// the kAhead visit positions of chunk `c` and returns the raw word, which
// the caller keeps in a register while the CTA works; ahead_store parks
// it in buffer `buf`. Threads 0-127: position k = thread / 8 and word
// thread % 8 of it (six box floats; the active flags of the box's first 32
// tiles as a bitmask, bit g for tile box * group + g; the box index).
// Threads 128-129: the early-exit bounds of the chunk's windows. So a gated
// CTA has at least kAheadThreads threads.
__device__ __forceinline__ unsigned ahead_load(const Gate& gate, const int* __restrict__ order,
                                               const float* __restrict__ suffmin,
                                               const int* __restrict__ tiles_on, int n_pos,
                                               int c) {
  const int tid = threadIdx.x;
  if (tid < kAhead * kAheadWords) {
    const int p = c * kAhead + tid / kAheadWords;
    const int word = tid % kAheadWords;
    if (p >= n_pos) return 0u;
    const int box = order[p];
    if (word < 6) return __float_as_uint(gate.boxes[6 * static_cast<size_t>(box) + word]);
    if (word == 7) return static_cast<unsigned>(box);
    unsigned flags = 0u;
    const int* group = tiles_on + static_cast<size_t>(box) * gate.group;
    for (int g = 0; g < gate.group && g < 32; ++g) flags |= (group[g] != 0 ? 1u : 0u) << g;
    return flags;
  }
  if (gate.window > 0 && tid < kAhead * kAheadWords + kAhead / gate.window) {
    const int w = c * (kAhead / gate.window) + tid - kAhead * kAheadWords;
    if (w < gate.n_windows) return __float_as_uint(suffmin[w]);
  }
  return 0u;
}

template <class Sh>
__device__ __forceinline__ void ahead_store(Sh& sh, int buf, unsigned word) {
  const int tid = threadIdx.x;
  if (tid < kAhead * kAheadWords) {
    sh.ahead[buf][tid / kAheadWords][tid % kAheadWords] = word;
  } else if (tid < kAhead * kAheadWords + 2) {
    sh.bound[buf][tid - kAhead * kAheadWords] = __uint_as_float(word);
  }
}

// Tile `it` swept by a CTA of block b: set its bit in the block's row of
// the bitmap, and count it for the block when no CTA of the block had.
__device__ __forceinline__ void mark_swept(const Visits& v, size_t b, int it) {
  const unsigned bit = 1u << (it % 32);
  if ((atomicOr(v.swept + b * v.words + it / 32, bit) & bit) == 0u) atomicAdd(v.block + b, 1);
}

// The next active tile of [from, end), or -1.
__device__ __forceinline__ int next_on(const int* __restrict__ tiles_on, int from, int end) {
  for (int it = from; it < end; ++it) {
    if (tiles_on[it] != 0) return it;
  }
  return -1;
}

// The thread's rays against the scene. Ungated: every active tile in
// order (a tile with no eligible triangle is an exact skip), each tile's
// first stage copied during the last stage of the tile before. Gated: the visit list
// of the gate block this CTA serves, read ahead kAhead positions at a time,
// each tile taken only when some live ray of the CTA needs it
// (__syncthreads_or: one instruction for the TPU's any-reduce over the
// block) and the list cut short at window starts once every ray of the CTA
// is settled (__syncthreads_and). tiles_on, the visit list and both votes
// are uniform across the CTA, so every thread takes the same branches and
// reaches every barrier; rays past the last vote "not needed" and
// "settled". Thread 0 writes the CTA's count of swept tiles to
// `visits.cta[blockIdx.x]`, marks each in the block's row of `visits.swept`
// (see struct Visits), each when it is given, and a gated CTA writes its
// times to row blockIdx.x of `gate.timeline`. Returns the count, the same
// in every thread of the CTA, and sets `positions` to the visit-list
// positions the CTA walked before the list ended or a window stopped it (0
// ungated).
template <bool kMatrix, bool kAny, bool kGate, int kRows, bool kMaskRow, int kSplit, int kCta,
          int kR, class Elig>
__device__ __forceinline__ int sweep_ray(Carry<kR>& c, const float* __restrict__ pack,
                                          int n_tri_pad, const int* __restrict__ tiles_on,
                                          int tile, const float* __restrict__ mask_row,
                                          const Gate& gate, Shared<kSplit, kCta, kGate>& sh,
                                          Elig elig, int2 place, int n_segments,
                                          const Visits& visits, int& positions) {
  static_assert(kRays % kCta == 0, "a CTA serves a whole part of one gate block");
  using L = Layout<kSplit, kCta, kR>;
  static_assert(!kGate || L::kThreads >= kAheadThreads, "the read-ahead's threads");
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    c.best_t[q] = kInf;
    c.best_code[q] = -1;
    c.any_hit[q] = 0;
  }
  int n_swept = 0;
  int buf = 0;
  positions = 0;
  const size_t b = cta_block<kCta>(place.x);
  const bool mark = visits.block != nullptr && threadIdx.x == 0;
  if constexpr (!kGate) {
    const int n_tiles = n_tri_pad / tile;
    const int per = (n_tiles + n_segments - 1) / n_segments;  // tiles a segment
    const int first = place.y * per;
    const int end = first + per < n_tiles ? first + per : n_tiles;
    int it = next_on(tiles_on, first, end);
    if (it >= 0) {
      stage_async<kRows, kMaskRow, L::kThreads>(sh.stage[buf], pack, n_tri_pad, it * tile,
                                                mask_row);
    }
    while (it >= 0) {
      const int next = next_on(tiles_on, it + 1, end);
      sweep_tile<kMatrix, kAny, kRows, kMaskRow, kSplit, kCta, kR>(
          c, pack, n_tri_pad, it, next, tile, mask_row, sh, buf, elig);
      ++n_swept;
      if (mark) mark_swept(visits, b, it);
      it = next;
    }
  } else {
    const size_t row = blockIdx.x;
    long long* __restrict__ timeline = gate.timeline;
    if (timeline != nullptr && threadIdx.x == 0) {
      timeline[4 * row] = global_ns();
      timeline[4 * row + 2] = sm_id();
    }
    int n_walked = 0;
    const int* __restrict__ order = gate.order + b * gate.n_boxes;
    const float* __restrict__ suffmin = gate.suffmin + b * gate.n_windows;
    const int n_pos = gate.counts[b];  // boxes on the visit list
    unsigned word = 0u;  // this thread's share of the next kAhead positions
    if (n_pos > 0) {
      ahead_store(sh, 0, ahead_load(gate, order, suffmin, tiles_on, n_pos, 0));
      if (n_pos > kAhead) word = ahead_load(gate, order, suffmin, tiles_on, n_pos, 1);
      __syncthreads();
    }
    int p = 0;
    for (; p < n_pos; ++p) {
      const int k = p % kAhead;
      const int abuf = (p / kAhead) & 1;
      if (k == 0 && p > 0) {
        // this buffer was last read kAhead positions ago, before their barriers
        ahead_store(sh, abuf, word);
        if (p + kAhead < n_pos) {
          word = ahead_load(gate, order, suffmin, tiles_on, n_pos, p / kAhead + 1);
        }
        __syncthreads();
      }
      // only the per-tile gate (group 1) has windows: position = box position
      if (gate.window > 0 && k % gate.window == 0) {
        const float bound = sh.bound[abuf][k / gate.window];
        bool settled = true;
#pragma unroll
        for (int q = 0; q < kR; ++q) {
          settled = settled && (!c.live[q] ||
                                (c.best_t[q] <= bound && (!kAny || c.any_hit[q] != 0)));
        }
        if (__syncthreads_and(settled)) break;  // no later box can pass
      }
      const unsigned* at = sh.ahead[abuf][k];
      const int box = static_cast<int>(at[7]);
      for (int g = 0; g < gate.group; ++g, ++n_walked) {
        const int it = box * gate.group + g;
        if (g < 32 ? (at[6] >> g & 1u) == 0u : tiles_on[it] == 0) continue;
        bool need = false;
#pragma unroll
        for (int q = 0; q < kR; ++q) {
          need = need || (c.live[q] && box_needed<kMatrix, kAny>(
                                           c.ray[q], reinterpret_cast<const float*>(at),
                                           c.best_t[q], c.any_hit[q]));
        }
        // no ray can improve: an exact skip, and of the rest of the group
        // too, whose tiles share this box and meet the same carries
        if (!__syncthreads_or(need)) {
          ++n_walked;
          break;
        }
        // the buffer is free: its last stage was read before the barrier
        // of the stage after it, or of this vote
        stage_async<kRows, kMaskRow, L::kThreads>(sh.stage[buf], pack, n_tri_pad, it * tile,
                                                  mask_row);
        sweep_tile<kMatrix, kAny, kRows, kMaskRow, kSplit, kCta, kR>(
            c, pack, n_tri_pad, it, -1, tile, mask_row, sh, buf, elig);
        ++n_swept;
        if (mark) mark_swept(visits, b, it);
      }
    }
    if (timeline != nullptr && threadIdx.x == 0) {
      timeline[4 * row + 1] = global_ns();
      timeline[4 * row + 3] = n_walked;
    }
    positions = p;
  }
  if (visits.cta != nullptr && threadIdx.x == 0) visits.cta[blockIdx.x] = n_swept;
  return n_swept;
}

// The CTA's share of the launch's work, when it is counted (`visits.work`):
// its swept tiles, and the pairs they held, each tile's triangles against
// the CTA's rays below n; gated, the boxes on its block's visit list and
// the positions it walked. Thread 0 adds each, once, at the CTA's end.
template <int kCta, bool kGate>
__device__ __forceinline__ void count_work(const Visits& visits, const Gate& gate, int n_swept,
                                           int positions, int tile, int n, int2 place) {
  if (visits.work == nullptr || threadIdx.x != 0) return;
  if (n_swept > 0) {
    const int below = n - place.x * kCta;
    const unsigned long long rays = below < kCta ? below : kCta;
    atomicAdd(visits.work, static_cast<unsigned long long>(n_swept));
    atomicAdd(visits.work + 1, static_cast<unsigned long long>(n_swept) * tile * rays);
  }
  if constexpr (kGate) {
    const int listed = gate.counts[cta_block<kCta>(place.x)];
    if (listed > 0) {
      atomicAdd(visits.work + 2, static_cast<unsigned long long>(listed));
      atomicAdd(visits.work + 3, static_cast<unsigned long long>(positions));
    }
  }
}

// A ray's result: the launch's outputs, or its segment's row of the
// partial results the fold kernel folds. code is -1 until a hit (best_t <
// kInf).
__device__ __forceinline__ void put_ray(const Segments& seg, int g, int n, int ray, float t,
                                        int code, int any_hit, int* __restrict__ codes,
                                        int* __restrict__ any_out) {
  if (seg.count > 1) {
    const size_t at = static_cast<size_t>(g) * n + ray;
    seg.t[at] = t;
    seg.code[at] = code;
    seg.any[at] = any_hit;
  } else {
    codes[ray] = code;
    any_out[ray] = any_hit;
  }
}

// The thread's rays of CTA place.x: loaded (rays past n load ray 0 and
// stay dead), and after the sweep written by the threads of part 0.
template <int kSplit, int kCta, int kR>
__device__ __forceinline__ void load_rays(Carry<kR>& c, const float* __restrict__ rays, int n,
                                          int2 place) {
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    const int ray = place.x * kCta + Layout<kSplit, kCta, kR>::ray(q);
    c.live[q] = ray < n;
    c.ray[q] = load_ray(rays, n, c.live[q] ? ray : 0);
  }
}

template <int kSplit, int kCta, int kR>
__device__ __forceinline__ void put_rays(const Carry<kR>& c, const Segments& seg, int n,
                                         int2 place, int* __restrict__ codes,
                                         int* __restrict__ any_out) {
  using L = Layout<kSplit, kCta, kR>;
  if (L::part() != 0) return;
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    if (c.live[q]) {
      put_ray(seg, place.y, n, place.x * kCta + L::ray(q), c.best_t[q], c.best_code[q],
              c.any_hit[q], codes, any_out);
    }
  }
}

// CTAs an SM must hold at once, which bounds the registers a thread: at one
// ray a thread 1,536 threads' worth (six CTAs of 256 threads: at most 40
// registers), at four 512 (128); a CTA of 1,024 threads, one (64).
constexpr int min_ctas(int threads, int rays_a_thread) {
  return threads >= 1024 ? 1 : (rays_a_thread == 1 ? 1536 : 512) / threads;
}

// CTA c serves rays [c * kCta, (c + 1) * kCta): the grid is ceil(n / kCta)
// CTAs, and the last may be partial.
template <bool kMatrix, bool kAny, bool kBaked, bool kGate, int kSplit, int kCta, int kR>
__global__ void __launch_bounds__(Layout<kSplit, kCta, kR>::kThreads,
                                  min_ctas(Layout<kSplit, kCta, kR>::kThreads, kR))
sweep_kernel(const float* __restrict__ rays, int n,
             const float* __restrict__ pack, int n_tri_pad,
             const int* __restrict__ tiles_on, int tile, Gate gate,
             int* __restrict__ codes, int* __restrict__ any_out,
             Visits visits, Segments seg) {
  __shared__ Shared<kSplit, kCta, kGate> sh;
  const int2 place = cta_place<kGate>(seg);
  // threads past the last ray still load stages and reach every barrier
  Carry<kR> c;
  load_rays<kSplit, kCta>(c, rays, n, place);
  int positions;
  const int n_swept = sweep_ray<kMatrix, kAny, kGate, kUsedRows, false, kSplit, kCta>(
      c, pack, n_tri_pad, tiles_on, tile, nullptr, gate, sh,
      PackMasks<!kBaked, !(kBaked && !kAny)>{}, place, seg.count, visits, positions);
  count_work<kCta, kGate>(visits, gate, n_swept, positions, tile, n, place);
  put_rays<kSplit, kCta>(c, seg, n, place, codes, any_out);
}

template <bool kMatrix, bool kAny, bool kGate, int kSplit, int kCta, int kR>
__global__ void __launch_bounds__(Layout<kSplit, kCta, kR>::kThreads,
                                  min_ctas(Layout<kSplit, kCta, kR>::kThreads, kR))
sweep_code_kernel(const float* __restrict__ rays, int n,
                  const float* __restrict__ pack, int n_tri_pad,
                  const int* __restrict__ tiles_on, int tile, float emit_code,
                  float min_code, Gate gate, int* __restrict__ codes,
                  int* __restrict__ any_out, Visits visits, Segments seg) {
  __shared__ Shared<kSplit, kCta, kGate> sh;
  const int2 place = cta_place<kGate>(seg);
  Carry<kR> c;
  load_rays<kSplit, kCta>(c, rays, n, place);
  int positions;
  const int n_swept = sweep_ray<kMatrix, kAny, kGate, kCodeRows, false, kSplit, kCta>(
      c, pack, n_tri_pad, tiles_on, tile, nullptr, gate, sh,
      CodeBounds{emit_code, min_code}, place, seg.count, visits, positions);
  count_work<kCta, kGate>(visits, gate, n_swept, positions, tile, n, place);
  put_rays<kSplit, kCta>(c, seg, n, place, codes, any_out);
}

// n is a multiple of kRays, so every CTA is whole; CTA c serves gate block
// c * kCta / 256 and emitter row emap[that block].
template <bool kMatrix, bool kAny, bool kGate, int kSplit, int kCta, int kR>
__global__ void __launch_bounds__(Layout<kSplit, kCta, kR>::kThreads,
                                  min_ctas(Layout<kSplit, kCta, kR>::kThreads, kR))
sweep_sched_kernel(const float* __restrict__ rays, int n,
                   const float* __restrict__ pack, int n_tri_pad,
                   const float* __restrict__ masks, int n_emit,
                   const int* __restrict__ emap, const int* __restrict__ tiles_on,
                   int tiles_stride, int tile, Gate gate, int* __restrict__ codes,
                   int* __restrict__ any_out, Visits visits, Segments seg) {
  __shared__ Shared<kSplit, kCta, kGate> sh;
  const int2 place = cta_place<kGate>(seg);
  const size_t cta = blockIdx.x;
  const int e = emap[cta_block<kCta>(place.x)];
  Carry<kR> c;
  if (e < 0 || e >= n_emit) {  // a row the masks do not hold sweeps nothing;
#pragma unroll                 // CTA-uniform, and before any barrier
    for (int q = 0; q < kR; ++q) {
      c.live[q] = true;
      c.best_t[q] = kInf;
      c.best_code[q] = -1;
      c.any_hit[q] = 0;
    }
    put_rays<kSplit, kCta>(c, seg, n, place, codes, any_out);
    if (threadIdx.x == 0) {
      if (visits.cta != nullptr) visits.cta[cta] = 0;
      if (kGate && gate.timeline != nullptr) {
        const long long now = global_ns();
        gate.timeline[4 * cta] = now;
        gate.timeline[4 * cta + 1] = now;
        gate.timeline[4 * cta + 2] = sm_id();
        gate.timeline[4 * cta + 3] = 0;
      }
    }
    return;
  }
  const size_t row = static_cast<size_t>(e);
  load_rays<kSplit, kCta>(c, rays, n, place);
  int positions;
  const int n_swept = sweep_ray<kMatrix, kAny, kGate, kCodeRows, true, kSplit, kCta>(
      c, pack, n_tri_pad, tiles_on + row * tiles_stride, tile, masks + row * n_tri_pad, gate,
      sh, CombinedMask{}, place, seg.count, visits, positions);
  count_work<kCta, kGate>(visits, gate, n_swept, positions, tile, n, place);
  put_rays<kSplit, kCta>(c, seg, n, place, codes, any_out);
}

template <bool kMatrix, bool kAny, bool kGate, int kSplit, int kCta, int kR>
void launch_masks(const Masks& m, const Args& a) {
  const dim3 grid((a.n + kCta - 1) / kCta * a.seg.count);
  const int threads = Layout<kSplit, kCta, kR>::kThreads;
  if (m.mode == kCodeMode) {
    sweep_code_kernel<kMatrix, kAny, kGate, kSplit, kCta, kR><<<grid, threads, 0, a.stream>>>(
        a.rays, a.n, a.pack, a.n_tri_pad, a.tiles_on, a.tile, m.emit_code, m.min_code,
        a.gate, a.codes, a.any_out, a.visits, a.seg);
  } else if (m.mode == kBakedMode) {
    sweep_kernel<kMatrix, kAny, true, kGate, kSplit, kCta, kR><<<grid, threads, 0, a.stream>>>(
        a.rays, a.n, a.pack, a.n_tri_pad, a.tiles_on, a.tile, a.gate, a.codes, a.any_out,
        a.visits, a.seg);
  } else {
    sweep_kernel<kMatrix, kAny, false, kGate, kSplit, kCta, kR><<<grid, threads, 0, a.stream>>>(
        a.rays, a.n, a.pack, a.n_tri_pad, a.tiles_on, a.tile, a.gate, a.codes, a.any_out,
        a.visits, a.seg);
  }
}

template <bool kMatrix, bool kAny, bool kGate, int kSplit, int kCta, int kR>
void launch_sched_gate(const Sched& s, const Args& a) {
  const int threads = Layout<kSplit, kCta, kR>::kThreads;
  sweep_sched_kernel<kMatrix, kAny, kGate, kSplit, kCta, kR>
      <<<a.n / kCta * a.seg.count, threads, 0, a.stream>>>(
          a.rays, a.n, a.pack, a.n_tri_pad, s.masks, s.n_emit, s.emap, a.tiles_on,
          s.tiles_stride, a.tile, a.gate, a.codes, a.any_out, a.visits, a.seg);
}

}  // namespace

// The instantiation a launch's wanted outputs select.
template <int kSplit, int kCta, bool kGate, int kR>
void launch_sweep(const Masks& m, const Args& a) {
  if (a.want_matrix && a.want_any) {
    launch_masks<true, true, kGate, kSplit, kCta, kR>(m, a);
  } else if (a.want_matrix) {
    launch_masks<true, false, kGate, kSplit, kCta, kR>(m, a);
  } else {
    launch_masks<false, true, kGate, kSplit, kCta, kR>(m, a);
  }
}

template <int kSplit, int kCta, bool kGate, int kR>
void launch_sweep_sched(const Sched& s, const Args& a) {
  if (a.want_matrix && a.want_any) {
    launch_sched_gate<true, true, kGate, kSplit, kCta, kR>(s, a);
  } else if (a.want_matrix) {
    launch_sched_gate<true, false, kGate, kSplit, kCta, kR>(s, a);
  } else {
    launch_sched_gate<false, true, kGate, kSplit, kCta, kR>(s, a);
  }
}

}  // namespace raystrack
