// What the sweeps' C entries (sweep.cu) and the translation units that hold
// the kernels (sweep_<rays>x<split>[r<rays a thread>][_gated].cu, each instantiating
// sweep_kernels.cuh for one CTA geometry, ungated or gated) share: the
// launch arguments, the geometries built and the two launch functions. One
// translation unit each keeps the build parallel: every .cu compiles in
// its own nvcc process.
#pragma once

#include <cuda_runtime.h>

namespace raystrack {

// The gate's per-call tables (ops/trace_cuda.py _gate_tables), one row per
// block of 256 rays. Block b visits positions j < counts[b] * group: box
// order[b][j / group], tile box * group + j % group (tiles_on is padded with
// inactive phantom tiles up to whole groups). With window > 0, at j % window
// == 0 a CTA serving the block stops once every ray of the CTA has best_t <=
// suffmin[b][j / window] (and any_hit set, when wanted).
struct Gate {
  const float* boxes;    // (n_boxes, 6): lo_x, lo_y, lo_z, hi_x, hi_y, hi_z
  const int* order;      // (n_blocks, n_boxes)
  const int* counts;     // (n_blocks,)
  const float* suffmin;  // (n_blocks, n_windows)
  long long* timeline;   // NULL, or (n_ctas, 4), a debug output: each CTA's start and
                         // end ns, its SM and the visit positions it walked
  int n_boxes;
  int group;
  int window;
  int n_windows;
};

// The visit counts, debug outputs (each NULL or given): `cta` one int per
// CTA, the tiles it swept; `block` one int per block of 256 rays, zeroed
// before the launch, the tiles any CTA serving the block swept (the
// 256-ray walk's count at every geometry), tallied through `swept`, a
// zeroed bitmap of `words` words a block: a CTA sets a tile's bit when it
// sweeps it and counts the tile when the bit was clear. `work` (NULL, or
// four int64) receives the launch's work, summed over its CTAs: the tiles
// swept, the pairs tested (each swept tile's triangles times the CTA's
// rays below n) and, gated, the boxes on the visit lists of the CTAs'
// blocks and the list positions the CTAs walked; thread 0 of each CTA adds
// its share once, at its end.
struct Visits {
  int* cta;
  int* block;
  unsigned* swept;
  int words;
  unsigned long long* work;
};

// Tile segments of an ungated launch: `count` CTAs serve each part of a
// block, CTA c sweeping tiles [g * per, (g + 1) * per) of the block's
// (g = c % count, per = ceil(tiles / count)) from a fresh carry; with count
// > 1 each writes its rays' (best t, code, any-hit) to row g of `t`, `code`
// and `any` ((count, n) each), which the fold kernel folds in order by the
// carry's rule into the launch's outputs.
struct Segments {
  int count;
  float* t;
  int* code;
  int* any;
};

struct Args {
  const float* rays;
  int n;
  const float* pack;
  int n_tri_pad;
  const int* tiles_on;
  int tile;
  int want_matrix;
  int want_any;
  Gate gate;  // order == NULL: ungated
  int* codes;
  int* any_out;
  Visits visits;
  Segments seg;  // count 1 for every gated launch
  cudaStream_t stream;
};

// Kernel #1's mask modes, in the order of ops/trace_cuda.py _MASK_MODES.
enum MaskMode { kRowsMode = 0, kBakedMode = 1, kCodeMode = 2 };

struct Masks {
  int mode;
  float emit_code;  // code mode only
  float min_code;
};

// Kernel #2's per-emitter operands.
struct Sched {
  const float* masks;  // (n_emit, n_tri_pad)
  int n_emit;
  const int* emap;     // (n / 256,)
  int tiles_stride;
};

// The geometries the kernels are built at, X(kSplit, kCta, kGate, kR) (ops/
// trace_cuda.py BUILT_GEOMETRIES), ungated ones at any count of tile
// segments: each instantiated in a translation unit of its own,
// sweep_<kCta>x<kSplit>[r<kR>][_gated].cu.
#define RAYSTRACK_SWEEP_GEOMETRIES(X)                                          \
  X(1, 256, false, 1) X(4, 256, false, 1) X(2, 256, false, 4) X(8, 256, false, 4) \
  X(4, 256, true, 1) X(16, 64, true, 4)

// Launch kernel #1 / kernel #2 at kCta rays a CTA, kSplit threads a ray and
// kR rays a thread, ungated or gated.
template <int kSplit, int kCta, bool kGate, int kR>
void launch_sweep(const Masks& m, const Args& a);
template <int kSplit, int kCta, bool kGate, int kR>
void launch_sweep_sched(const Sched& s, const Args& a);

}  // namespace raystrack
