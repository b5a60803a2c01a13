// The C entries of the two sweep kernels: they check the launch's shape and
// hand it to the instantiation of its CTA geometry (rays a CTA, threads a
// ray, rays a thread). The kernels, and the notes on what they replace, what bounds them
// and what their design does about it, are in sweep_kernels.cuh; each
// geometry compiles in a translation unit of its own.
#include <cuda_runtime.h>

#include "gate.cuh"
#include "sweep.cuh"

namespace {

using namespace raystrack;

constexpr int kRays = 256;   // rays per gate block (sweep_kernels.cuh)
constexpr int kStage = 128;  // triangles per shared-memory stage

// Whether kernels are built at this geometry (RAYSTRACK_SWEEP_GEOMETRIES).
bool built(int split, int rays_cta, bool gated, int per_thread) {
#define RAYSTRACK_BUILT(S, C, G, R) \
  if (split == S && rays_cta == C && gated == G && per_thread == R) return true;
  RAYSTRACK_SWEEP_GEOMETRIES(RAYSTRACK_BUILT)
#undef RAYSTRACK_BUILT
  return false;
}

bool bad_shape(int n, int n_tri_pad, int tile, int want_matrix, int want_any, int split,
               int rays_cta, bool gated, int per_thread) {
  return n < 0 || tile <= 0 || tile % kStage != 0 || n_tri_pad % tile != 0 ||
         !(want_matrix || want_any) || !built(split, rays_cta, gated, per_thread);
}

// Tile indices a sweep can reach: the pack's tiles, and a gated sweep's
// phantom tiles up to whole groups.
int reach(int n_tri_pad, int tile, const Gate& g) {
  const int n_tiles = tile > 0 ? n_tri_pad / tile : 0;
  if (g.order == nullptr || g.group < 1) return n_tiles;
  return (n_tiles + g.group - 1) / g.group * g.group;
}

// Tile segments: one for a gated launch; past one, their partial results'
// buffers.
bool bad_segments(const Segments& s, bool gated) {
  return s.count < 1 || (gated && s.count != 1) ||
         (s.count > 1 && (s.t == nullptr || s.code == nullptr || s.any == nullptr));
}

// The fold of an ungated launch's tile segments, one thread a ray: each
// segment's (best t, code, any-hit) in segment order, by the carry's rule
// (only a strictly smaller t replaces it; the any-hit is an OR), so the
// result is the one-segment walk's bit for bit.
__global__ void sweep_fold_kernel(int n, Segments seg, int* __restrict__ codes,
                                  int* __restrict__ any_out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  float best_t = kInf;
  int code = -1;
  int any_hit = 0;
  for (int g = 0; g < seg.count; ++g) {
    const size_t at = static_cast<size_t>(g) * n + ray;
    const float t = seg.t[at];
    if (t < best_t) {
      best_t = t;
      code = seg.code[at];
    }
    any_hit |= seg.any[at];
  }
  codes[ray] = code;
  any_out[ray] = any_hit;
}

void fold_segments(const Args& a) {
  if (a.seg.count > 1) {
    sweep_fold_kernel<<<(a.n + 255) / 256, 256, 0, a.stream>>>(a.n, a.seg, a.codes, a.any_out);
  }
}

// A block count needs its bitmap, wide enough for every tile.
bool bad_visits(const Visits& v, int n_tiles) {
  return (v.block == nullptr) != (v.swept == nullptr) ||
         (v.block != nullptr && v.words * 32 < n_tiles);
}

// A gate is given when `order` is not NULL; then all its tables must be.
// Only a gated launch writes a timeline.
bool bad_gate(const Gate& g) {
  if (g.order == nullptr) return g.timeline != nullptr;
  return g.boxes == nullptr || g.counts == nullptr || g.n_boxes <= 0 || g.group < 1 ||
         (g.window != 0 && g.window != 8 && g.window != 16) ||
         (g.window > 0 && (g.suffmin == nullptr || g.n_windows * g.window < g.n_boxes));
}

}  // namespace

// Launches kernel #1 on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was accepted). `tile` must be a
// multiple of 128 that divides n_tri_pad; at least one output is wanted.
// mask_mode is 0 (the pack's mask rows), 1 (a baked pack) or 2 (the pack's
// code row against emit_code and min_code, which the other modes ignore).
// With a gate (`order` not NULL) the tables are those of ops/trace_cuda.py
// _gate_tables for these rays: one row per block of 256 rays, tiles_on
// padded to whole groups, a window of 0, 8 or 16. `rays_cta` rays make a
// CTA (CTA c serves rays [c * rays_cta, (c + 1) * rays_cta)), `split`
// threads share a ray's triangles and a thread holds `per_thread` rays: a
// geometry of RAYSTRACK_SWEEP_GEOMETRIES (sweep.cuh), others are refused.
// `segments` CTAs (1 gated) serve each part of a block, one a tile segment,
// with their partial results in `seg_t`, `seg_code` and `seg_any` ((segments,
// n) each; NULL for one segment), which a second kernel, launched after the
// sweep on the same stream, folds into `codes` and `any_out`.
// `visits` (NULL, or one int per CTA, segments counted) receives each CTA's
// count of swept tiles; `block_visits` (NULL, or one int per block of 256 rays, zeroed)
// each block's count of tiles any of its CTAs swept, through `swept` (then
// a zeroed bitmap of `swept_words` >= ceil(tiles / 32) words a block);
// `work` (NULL, or four int64 the launch adds to) the tiles its CTAs swept,
// the pairs they tested, and gated the boxes listed and walked (struct
// Visits);
// `timeline` (NULL, or four int64 per CTA; gated launches only) each CTA's
// start and end on the card's nanosecond timer, its SM and the visit
// positions it walked.
extern "C" int raystrack_sweep_rays(const float* rays, int n, const float* pack,
                                    int n_tri_pad, const int* tiles_on, int tile,
                                    int want_matrix, int want_any, int mask_mode,
                                    float emit_code, float min_code, const float* boxes,
                                    const int* order, const int* counts,
                                    const float* suffmin, int n_boxes, int group,
                                    int window, int n_windows, int split, int rays_cta,
                                    int segments, int per_thread, float* seg_t, int* seg_code,
                                    int* seg_any,
                                    int* codes, int* any_out, int* visits,
                                    int* block_visits, unsigned* swept, int swept_words,
                                    unsigned long long* work, long long* timeline,
                                    void* stream) {
  const Gate gate{boxes, order, counts, suffmin, timeline, n_boxes, group, window, n_windows};
  const bool gated = order != nullptr;
  if (bad_shape(n, n_tri_pad, tile, want_matrix, want_any, split, rays_cta, gated,
                per_thread) ||
      bad_gate(gate) || mask_mode < kRowsMode || mask_mode > kCodeMode ||
      bad_visits(Visits{visits, block_visits, swept, swept_words, work}, reach(n_tri_pad, tile, gate)) ||
      bad_segments(Segments{segments, seg_t, seg_code, seg_any}, gated)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Args a{rays, n, pack, n_tri_pad, tiles_on, tile, want_matrix, want_any, gate,
               codes, any_out, Visits{visits, block_visits, swept, swept_words, work},
               Segments{segments, seg_t, seg_code, seg_any}, static_cast<cudaStream_t>(stream)};
  const Masks m{mask_mode, emit_code, min_code};
#define RAYSTRACK_LAUNCH(S, C, G, R)                                   \
  if (split == S && rays_cta == C && gated == G && per_thread == R) \
    launch_sweep<S, C, G, R>(m, a);
  RAYSTRACK_SWEEP_GEOMETRIES(RAYSTRACK_LAUNCH)
#undef RAYSTRACK_LAUNCH
  fold_segments(a);
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
    int n_windows, int split, int rays_cta, int segments, int per_thread, float* seg_t,
    int* seg_code, int* seg_any, int* codes, int* any_out, int* visits, int* block_visits,
    unsigned* swept, int swept_words, unsigned long long* work, long long* timeline,
    void* stream) {
  const Gate gate{boxes, order, counts, suffmin, timeline, n_boxes, group, window, n_windows};
  const bool gated = order != nullptr;
  if (bad_shape(n, n_tri_pad, tile, want_matrix, want_any, split, rays_cta, gated,
                per_thread) ||
      bad_gate(gate) || n % kRays != 0 || n_emit < 0 || tiles_stride < n_tri_pad / tile ||
      bad_visits(Visits{visits, block_visits, swept, swept_words, work}, reach(n_tri_pad, tile, gate)) ||
      bad_segments(Segments{segments, seg_t, seg_code, seg_any}, gated)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Args a{rays, n, pack, n_tri_pad, tiles_on, tile, want_matrix, want_any, gate,
               codes, any_out, Visits{visits, block_visits, swept, swept_words, work},
               Segments{segments, seg_t, seg_code, seg_any}, static_cast<cudaStream_t>(stream)};
  const Sched s{masks, n_emit, emap, tiles_stride};
#define RAYSTRACK_LAUNCH(S, C, G, R)                                   \
  if (split == S && rays_cta == C && gated == G && per_thread == R) \
    launch_sweep_sched<S, C, G, R>(s, a);
  RAYSTRACK_SWEEP_GEOMETRIES(RAYSTRACK_LAUNCH)
#undef RAYSTRACK_LAUNCH
  fold_segments(a);
  return static_cast<int>(cudaGetLastError());
}
