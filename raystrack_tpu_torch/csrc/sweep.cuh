// What the sweeps' C entries (sweep.cu) and the translation units that hold
// the kernels (sweep_split1.cu, sweep_split4.cu and sweep_gated.cu, each
// instantiating sweep_kernels.cuh for one triangle split, ungated or gated)
// share: the launch arguments and the two launch
// functions. One translation unit each keeps the build parallel: every .cu
// compiles in its own nvcc process.
#pragma once

#include <cuda_runtime.h>

namespace raystrack {

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
  long long* timeline;   // NULL, or (n_blocks, 4), a debug output: each block's start and
                         // end ns, its SM and the visit positions it walked
  int n_boxes;
  int group;
  int window;
  int n_windows;
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
  int* visits;  // NULL, or one int per ray block: tiles swept
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

// Threads a ray of every gated launch (ops/trace_cuda.py sweep_split).
constexpr int kGatedSplit = 4;

// Launch kernel #1 / kernel #2 with kSplit threads a ray, ungated or gated:
// instantiated in sweep_split<kSplit>.cu (ungated) and sweep_gated.cu.
template <int kSplit, bool kGate>
void launch_sweep(const Masks& m, const Args& a);
template <int kSplit, bool kGate>
void launch_sweep_sched(const Sched& s, const Args& a);

}  // namespace raystrack
