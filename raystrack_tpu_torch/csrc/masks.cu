// A scheduled round's combined eligibility rows: for E emitter rows and
// Tpad triangles, out (E, Tpad) f32 in {0, 1, 2}, m_any + m_mat of emitter
// e at triangle t, with the plane cull of a planar emitter folded in.
//
// It replaces no TPU kernel: the JAX package builds these rows in XLA code,
// compute_masks (raystrack_tpu/ops/trace.py:101) under jax.vmap over the
// round's emitters (:731). In eager tensor ops (ops/trace.py
// combined_masks_reference) that is some forty launches over (E, Tpad), a
// dozen (E, Tpad) f32 temporaries at the peak and about thirty times the
// bytes the rows need. So it is one kernel here.
//
// What bounds it: bytes. Per triangle it reads sid (4 bytes) once, v0, e1,
// e2 (36) once when a row of the round is planar, and writes 4 bytes a row,
// E of them; a few dozen operations a row beside that is far below the
// card's compute. The design is the least traffic and coalesced access:
//
// - one thread a triangle, 256 a CTA, the grid from Tpad alone. Each
//   thread reads its sid once and, when any row of the round is planar (a
//   CTA-wide flag from the rows' is_planar), its triangle's three 12-byte
//   rows (a warp reads contiguous bytes), and keeps them in registers: only
//   the plane test reads the geometry, and a round of boxes has none;
// - it then loops over the E rows and stores out[e, t]: a warp's stores
//   are one contiguous 128-byte line a row;
// - each CTA stages the rows' scalars (emit_sid, min_sid, the plane) in
//   shared memory, kStage rows at a time, so a thread reads them as
//   broadcasts; surf_active_ext[e, sid], a table of E x (S + 1) ints, is
//   read through the read-only cache;
// - the plane test is taken only where it can change the row: when the
//   triangle is eligible (m_any) and the emitter planar.
//
// Bitwise equal to the plain version: the signed distances round each
// product, sum and difference on its own (__fmul_rn, __fadd_rn, __fsub_rn)
// in torch's order, and the maximum propagates NaN as torch.maximum does
// (fmaxf would drop it), so a NaN distance leaves the triangle unreachable.
//
// Layouts: v0, e1, e2 (Tpad, 3) f32 rows; sid (Tpad,) i32, the padding
// triangles' sid n_surf; ext (E, n_cols) i32, n_cols = n_surf + 1 with a
// zero last column; emit_sid, min_sid (E,) i32; plane (E, 8) f32 [origin(3),
// normal(3), tol, is_planar]; out (E, Tpad) f32.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 64;  // emitter rows a CTA stages in shared memory at a time

// torch.maximum: a NaN on either side is the result
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float dot_rn(float x, float y, float z, float nx, float ny,
                                        float nz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, nx), __fmul_rn(y, ny)), __fmul_rn(z, nz));
}

__global__ void __launch_bounds__(kThreads)
mask_rows_kernel(const float* __restrict__ v0, const float* __restrict__ e1,
                 const float* __restrict__ e2, const int* __restrict__ sid,
                 const int* __restrict__ ext, int n_cols, const int* __restrict__ emit_sid,
                 const int* __restrict__ min_sid, const float* __restrict__ plane, int n_emit,
                 int n_tri, float* __restrict__ out) {
  __shared__ float s_plane[kStage][8];
  __shared__ int s_emit[kStage];
  __shared__ int s_min[kStage];
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = t < n_tri;
  bool planar = false;  // is any row of the round planar (the plane test's is_planar)
  for (int i = threadIdx.x; i < n_emit; i += kThreads) {
    planar |= plane[static_cast<size_t>(i) * 8 + 7] > 0.0f;
  }
  planar = __syncthreads_or(planar);
  float a[3] = {0.0f, 0.0f, 0.0f}, b[3] = {0.0f, 0.0f, 0.0f}, c[3] = {0.0f, 0.0f, 0.0f};
  int s = 0;
  if (live) {
    s = sid[t];
    if (planar) {
      const size_t at = static_cast<size_t>(t) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        a[k] = v0[at + k];
        b[k] = e1[at + k];
        c[k] = e2[at + k];
      }
    }
  }
  for (int e0 = 0; e0 < n_emit; e0 += kStage) {
    const int n = min(kStage, n_emit - e0);
    __syncthreads();  // the previous stage is no longer read
    for (int i = threadIdx.x; i < n * 8; i += kThreads) {
      s_plane[i / 8][i % 8] = plane[e0 * 8 + i];
    }
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s_emit[i] = emit_sid[e0 + i];
      s_min[i] = min_sid[e0 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i) {
      const int e = e0 + i;
      const bool m_any =
          __ldg(ext + static_cast<size_t>(e) * n_cols + s) > 0 && s != s_emit[i];
      float v = 0.0f;
      if (m_any) {
        const float* p = s_plane[i];
        bool keep = !(p[7] > 0.0f);
        if (!keep) {
          const float nx = p[3], ny = p[4], nz = p[5];
          const float s0 = dot_rn(__fsub_rn(a[0], p[0]), __fsub_rn(a[1], p[1]),
                                  __fsub_rn(a[2], p[2]), nx, ny, nz);
          const float s1 = __fadd_rn(s0, dot_rn(b[0], b[1], b[2], nx, ny, nz));
          const float s2 = __fadd_rn(s0, dot_rn(c[0], c[1], c[2], nx, ny, nz));
          keep = max_nan(max_nan(s0, s1), s2) > p[6];
        }
        if (keep) v = s >= s_min[i] ? 2.0f : 1.0f;
      }
      out[static_cast<size_t>(e) * n_tri + t] = v;
    }
  }
}

}  // namespace

// Launches the kernel on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was accepted); nothing is launched
// when there is no row or no triangle.
extern "C" int raystrack_mask_rows(const float* v0, const float* e1, const float* e2,
                                   const int* sid, const int* ext, int n_cols,
                                   const int* emit_sid, const int* min_sid, const float* plane,
                                   int n_emit, int n_tri, float* out, void* stream) {
  if (n_emit < 0 || n_tri < 0 || n_cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_emit == 0 || n_tri == 0) return static_cast<int>(cudaSuccess);
  const long long n_ctas = (static_cast<long long>(n_tri) + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(n_ctas));
  mask_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v0, e1, e2, sid, ext, n_cols, emit_sid, min_sid, plane, n_emit, n_tri, out);
  return static_cast<int>(cudaGetLastError());
}
