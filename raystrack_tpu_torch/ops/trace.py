"""One chunk of the QMC solve: ray generation, sweep, per-surface histograms.

Counterpart of ``raystrack_tpu/ops/trace.py`` (``generate_rays``,
``compute_masks`` and ``chunk_body_pallas``). One call traces ``chunk``
Monte-Carlo iterations of one emitter:

    rays   <- stratified Halton emission with Cranley-Patterson rotation
    sweep  <- all-pairs Möller–Trumbore against the scene (ops/trace_cuda.py)
    reduce <- per-surface front/back hit histograms

and returns only (chunk, n_surf) int32 count tensors. Everything here is
plain PyTorch on the solve's device; the sweep is the only kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import PALLAS_TRI_TILE
from .trace_cuda import build_tri_pack, sweep_rays

TWO_PI = 6.283185307179586


def generate_rays(tables: Tuple, geom: Tuple, cp: torch.Tensor):
    """Ray origins and directions for ``chunk`` iterations.

    tables: per-ray (N,) f32 tensors (u_cell, v_cell, h_tri, h_u, h_v, h_r1, h_r2),
    geom:   (cdf, tri_a, tri_e1, tri_e2, tri_u, tri_v, tri_n, tri_eps),
    cp:     (chunk, 7) Cranley-Patterson offsets
            [grid_u, grid_v, tri, bary_u, bary_v, hemi_r1, hemi_r2].

    Per ray: jittered stratified cell -> area-CDF triangle pick -> uniform
    barycentric point -> cosine-weighted hemisphere direction in the
    triangle's tangent frame -> origin offset by eps * normal. Returns
    (chunk, N, 3) origins and directions.
    """
    u_cell, v_cell, h_tri, h_u, h_v, h_r1, h_r2 = (t[None, :] for t in tables)
    cdf, tri_a, tri_e1, tri_e2, tri_u, tri_v, tri_n, tri_eps = geom
    n_faces = cdf.shape[0]
    off = lambda k: cp[:, k : k + 1]  # noqa: E731 - (chunk, 1) offset column

    ug = torch.remainder(u_cell + off(0), 1.0)
    vg = torch.remainder(v_cell + off(1), 1.0)

    q_tri = torch.remainder(h_tri + off(2), 1.0)
    tri = torch.searchsorted(cdf, q_tri, right=False).clamp_(0, n_faces - 1)

    ur = torch.remainder(h_u + off(3) + ug, 1.0)
    vr = torch.remainder(h_v + off(4) + vg, 1.0)
    s = torch.sqrt(ur)
    mix_b = (s * vr)[..., None]
    mix_c = (s * (1.0 - vr))[..., None]
    point = tri_a[tri] + mix_b * tri_e1[tri] + mix_c * tri_e2[tri]

    r1 = torch.remainder(h_r1 + off(5), 1.0)
    r2 = torch.remainder(h_r2 + off(6), 1.0)
    sin_t = torch.sqrt(1.0 - r1)
    phi = TWO_PI * r2
    lx = (sin_t * torch.cos(phi))[..., None]
    ly = (sin_t * torch.sin(phi))[..., None]
    lz = torch.sqrt(r1)[..., None]
    normal = tri_n[tri]
    direction = lx * tri_u[tri] + ly * tri_v[tri] + lz * normal
    origin = point + tri_eps[tri][..., None] * normal
    return origin, direction


def ray_pack(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The sweep's (9, N) f32 ray rows ``[o | d | o x d]`` from (..., 3)
    origins and directions (flattened in order)."""
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    cross = (oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx)
    return torch.stack((ox, oy, oz, dx, dy, dz) + cross)


def compute_masks(scene: Tuple, surf_active_ext, emit_sid: int, min_sid: int,
                  plane_vec=None):
    """Per-triangle (sky-eligible, matrix-eligible) bool masks for one emitter.

    Folds the active-surface vector, emitter exclusion, the reciprocity
    half-matrix minimum sid, and — for planar emitters — triangle-exact
    plane culling: a triangle whose three vertices all lie at signed
    distance <= plane_tol behind the emission plane can never be hit by a
    ray launched from that plane.

    ``plane_vec`` is an (8,) f32 tensor ``[origin(3), normal(3), tol, is_planar]``.
    """
    v0, e1, e2, cross_e, w_u, w_v, d0, sid = scene
    active = surf_active_ext[sid] > 0
    m_any = active & (sid != emit_sid)
    m_mat = m_any & (sid >= min_sid)
    if plane_vec is not None:
        nx, ny, nz = plane_vec[3], plane_vec[4], plane_vec[5]
        dot = lambda a: a[:, 0] * nx + a[:, 1] * ny + a[:, 2] * nz  # noqa: E731
        s0 = dot(v0 - plane_vec[:3])
        s1 = s0 + dot(e1)
        s2 = s0 + dot(e2)
        reachable = torch.maximum(torch.maximum(s0, s1), s2) > plane_vec[6]
        # a tensor test, not a host branch: reading the flag would sync
        keep = reachable | ~(plane_vec[7] > 0.0)
        m_any = m_any & keep
        m_mat = m_mat & keep
    return m_any, m_mat


def emitter_operands(scene: Tuple, surf_active_ext, emit_sid: int, min_sid: int,
                     plane_vec=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sweep operands of one emitter, fixed for its whole solve: the
    (24, Tpad) pack with the primary (matrix) mask baked in, and that mask
    (Tpad,) bool, which decides the tiles the sweep skips."""
    m_any, m_mat = compute_masks(scene, surf_active_ext, emit_sid, min_sid, plane_vec)
    return build_tri_pack(scene, m_any, m_mat, bake=m_mat), m_mat


def chunk_body(
    tri_pack: torch.Tensor,
    sweep_mask: torch.Tensor,
    tables: Tuple,
    geom: Tuple,
    cp: torch.Tensor,
    n_surf: int,
    n_rays_once: int,
) -> Dict[str, torch.Tensor]:
    """Trace ``chunk = cp.shape[0]`` iterations of one emitter.

    Sweeps against the operands of :func:`emitter_operands`, drops padded
    tail rays, and returns per-iteration ``counts_f`` / ``counts_b``
    (chunk, n_surf) int32 hit counts, left on the solve's device.
    """
    chunk = cp.shape[0]
    n_local = tables[0].shape[0]
    device = cp.device

    o, d = generate_rays(tables, geom, cp)
    codes, _ = sweep_rays(
        ray_pack(o, d), tri_pack, sweep_mask, tri_tile=PALLAS_TRI_TILE,
        want_matrix=True, want_any=False, masks_baked=True,
    )

    # per-iteration histogram of codes 0..2*n_surf-1 (sid*2 + front); misses,
    # padded tail rays and anything out of range land in a discarded bin
    codes = codes.reshape(chunk, n_local).to(torch.int64)
    ray_valid = torch.arange(n_local, device=device) < n_rays_once
    n_bins = 2 * n_surf + 1
    codes = torch.where(ray_valid & (codes >= 0) & (codes < 2 * n_surf), codes, 2 * n_surf)
    idx = codes + n_bins * torch.arange(chunk, device=device)[:, None]
    counts = torch.zeros(chunk * n_bins, dtype=torch.int32, device=device)
    counts.index_add_(0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.int32, device=device))
    counts = counts.reshape(chunk, n_bins)[:, : 2 * n_surf].reshape(chunk, n_surf, 2)
    return {"counts_b": counts[:, :, 0], "counts_f": counts[:, :, 1]}


__all__ = ["generate_rays", "ray_pack", "compute_masks", "emitter_operands", "chunk_body"]
