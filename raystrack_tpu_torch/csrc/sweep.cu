// The C entries of the two sweep kernels: they check the launch's shape and
// hand it to the instantiation of its triangle split. The kernels, and the
// notes on what they replace, what bounds them and what their design does
// about it, are in sweep_kernels.cuh; each split compiles in a translation
// unit of its own (sweep_split1.cu and sweep_split4.cu ungated, sweep_gated.cu
// gated).
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

using namespace raystrack;

constexpr int kRays = 256;   // rays per block (sweep_kernels.cuh)
constexpr int kStage = 128;  // triangles per shared-memory stage

// The splits that are built: 1 or 4 ungated, kGatedSplit gated.
bool bad_shape(int n, int n_tri_pad, int tile, int want_matrix, int want_any, int split,
               bool gated) {
  return n < 0 || tile <= 0 || tile % kStage != 0 || n_tri_pad % tile != 0 ||
         !(want_matrix || want_any) ||
         !(gated ? split == kGatedSplit : split == 1 || split == 4);
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
// padded to whole groups, a window of 0, 8 or 16. `split` is the number of
// threads that share a ray's triangles: 1 or 4 ungated, 4 gated.
// `visits` (NULL, or one int per ray block) receives each block's count of
// swept tiles; `timeline` (NULL, or four int64 per ray block; gated launches
// only) its start and end on the card's nanosecond timer, its SM and the
// visit positions it walked.
extern "C" int raystrack_sweep_rays(const float* rays, int n, const float* pack,
                                    int n_tri_pad, const int* tiles_on, int tile,
                                    int want_matrix, int want_any, int mask_mode,
                                    float emit_code, float min_code, const float* boxes,
                                    const int* order, const int* counts,
                                    const float* suffmin, int n_boxes, int group,
                                    int window, int n_windows, int split,
                                    int* codes, int* any_out, int* visits,
                                    long long* timeline, void* stream) {
  const Gate gate{boxes, order, counts, suffmin, timeline, n_boxes, group, window, n_windows};
  const bool gated = order != nullptr;
  if (bad_shape(n, n_tri_pad, tile, want_matrix, want_any, split, gated) || bad_gate(gate) ||
      mask_mode < kRowsMode || mask_mode > kCodeMode) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Args a{rays, n, pack, n_tri_pad, tiles_on, tile, want_matrix, want_any, gate,
               codes, any_out, visits, static_cast<cudaStream_t>(stream)};
  const Masks m{mask_mode, emit_code, min_code};
  if (gated) {
    launch_sweep<kGatedSplit, true>(m, a);
  } else if (split == 4) {
    launch_sweep<4, false>(m, a);
  } else {
    launch_sweep<1, false>(m, a);
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
    int n_windows, int split, int* codes, int* any_out, int* visits, long long* timeline,
    void* stream) {
  const Gate gate{boxes, order, counts, suffmin, timeline, n_boxes, group, window, n_windows};
  const bool gated = order != nullptr;
  if (bad_shape(n, n_tri_pad, tile, want_matrix, want_any, split, gated) || bad_gate(gate) ||
      n % kRays != 0 || n_emit < 0 || tiles_stride < n_tri_pad / tile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Args a{rays, n, pack, n_tri_pad, tiles_on, tile, want_matrix, want_any, gate,
               codes, any_out, visits, static_cast<cudaStream_t>(stream)};
  const Sched s{masks, n_emit, emap, tiles_stride};
  if (gated) {
    launch_sweep_sched<kGatedSplit, true>(s, a);
  } else if (split == 4) {
    launch_sweep_sched<4, false>(s, a);
  } else {
    launch_sweep_sched<1, false>(s, a);
  }
  return static_cast<int>(cudaGetLastError());
}
