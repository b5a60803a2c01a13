"""The QMC solve's device step: ray generation, sweep, per-surface histograms.

Counterpart of ``raystrack_tpu/ops/trace.py`` (``generate_rays``,
``compute_masks``, ``chunk_body_pallas``, ``scheduled_trace_pallas`` and
``pack_outputs``/``unpack_outputs``). Two entry points:

- :func:`chunk_body` traces ``chunk`` Monte-Carlo iterations of one
  emitter (the per-emitter route, sweep kernel #1);
- :func:`scheduled_trace` traces a block schedule that spans many
  emitters and iterations in one dispatch (the scheduled route, sweep
  kernel #2).

Both run

    rays   <- stratified Halton emission with Cranley-Patterson rotation
    sweep  <- all-pairs Möller–Trumbore against the scene (ops/trace_cuda.py)
    reduce <- per-row front/back hit counts per surface (count_codes)

and return only int32 count tensors. Everything here is plain PyTorch on
the solve's device; the sweeps and the count are the kernels.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import PALLAS_TRI_TILE
from .count_cuda import count_codes
from .trace_cuda import RAY_SUBBLOCK, build_tri_pack, sweep_rays, sweep_rays_scheduled

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


def combined_masks(scene: Tuple, surf_active_ext, emit_sid, min_sid,
                   plane_vec) -> torch.Tensor:
    """The (E, Tpad) f32 combined eligibility rows ``m_any + m_mat`` in
    {0, 1, 2} of E emitters at once (m_mat is a subset of m_any).

    Row e equals :func:`compute_masks` of emitter e bitwise: the same ops
    in the same order, broadcast over (E, Tpad), so the number of launches
    does not grow with E. ``surf_active_ext`` is (E, S+1) int32,
    ``emit_sid``/``min_sid`` (E,) int32 and ``plane_vec`` (E, 8) f32.
    """
    v0, e1, e2, cross_e, w_u, w_v, d0, sid = scene
    col = lambda t: t[:, None]  # noqa: E731 - (E, 1) per-emitter column
    active = surf_active_ext[:, sid.long()] > 0
    m_any = active & (sid[None, :] != col(emit_sid))
    m_mat = m_any & (sid[None, :] >= col(min_sid))
    nx, ny, nz = col(plane_vec[:, 3]), col(plane_vec[:, 4]), col(plane_vec[:, 5])
    s0 = ((v0[:, 0] - col(plane_vec[:, 0])) * nx + (v0[:, 1] - col(plane_vec[:, 1])) * ny
          + (v0[:, 2] - col(plane_vec[:, 2])) * nz)
    s1 = s0 + (e1[:, 0] * nx + e1[:, 1] * ny + e1[:, 2] * nz)
    s2 = s0 + (e2[:, 0] * nx + e2[:, 1] * ny + e2[:, 2] * nz)
    reachable = torch.maximum(torch.maximum(s0, s1), s2) > col(plane_vec[:, 6])
    keep = reachable | ~(col(plane_vec[:, 7]) > 0.0)
    return (m_any & keep).to(torch.float32) + (m_mat & keep).to(torch.float32)


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
    n_valid = torch.full((chunk,), min(n_rays_once, n_local), dtype=torch.int32,
                         device=device)
    counts_f, counts_b = count_codes(codes.view(chunk, n_local), n_valid, n_surf)
    return {"counts_b": counts_b, "counts_f": counts_f}


def scheduled_rays(tables_flat: Tuple, geom_stacked: Tuple, cp: torch.Tensor,
                   n_rays_once: torch.Tensor, schedule: torch.Tensor, sel: torch.Tensor,
                   *, sched_block: int):
    """Rays of every schedule row at once: (nb, SB, 3) origins and
    directions, and the (nb,) int32 count of each row's leading rays that
    are real (the rest pad the emitter's last block).

    Row r of the (nb, 4) int32 schedule ``[emitter_row, cp_row, table_off,
    ray_base]`` traces ``sched_block`` rays of emitter ``sel[emitter_row]``
    from flat-table row ``table_off / sched_block`` with CP row ``cp_row``;
    ``n_rays_once`` (E,) is indexed by emitter row. The ops and their order
    are those of :func:`generate_rays`, with the tables taken per row and
    the geometry gathered per ray (the JAX package's gather formulation),
    so a ray equals its per-emitter twin bitwise on one device.
    """
    cdf_s, tri_a, tri_e1, tri_e2, tri_u, tri_v, tri_n, tri_eps = geom_stacked
    n_geom, f_max = cdf_s.shape
    emit = sel[schedule[:, 0].long()].long()  # (nb,) rows of the geometry stack
    row_ids = (schedule[:, 2] // sched_block).long()
    u_cell, v_cell, h_tri, h_u, h_v, h_r1, h_r2 = (
        t.view(-1, sched_block).index_select(0, row_ids) for t in tables_flat
    )
    cp_b = cp.index_select(0, schedule[:, 1].long())
    off = lambda k: cp_b[:, k : k + 1]  # noqa: E731 - (nb, 1) offset column

    ug = torch.remainder(u_cell + off(0), 1.0)
    vg = torch.remainder(v_cell + off(1), 1.0)

    q_tri = torch.remainder(h_tri + off(2), 1.0)
    cdf_b = cdf_s.index_select(0, emit)
    tri = torch.searchsorted(cdf_b, q_tri, right=False).clamp_(0, f_max - 1)
    gidx = (emit[:, None] * f_max + tri).reshape(-1)
    take = lambda g: g.reshape(n_geom * f_max, -1).index_select(0, gidx).reshape(  # noqa: E731
        tri.shape + g.shape[2:])

    ur = torch.remainder(h_u + off(3) + ug, 1.0)
    vr = torch.remainder(h_v + off(4) + vg, 1.0)
    s = torch.sqrt(ur)
    mix_b = (s * vr)[..., None]
    mix_c = (s * (1.0 - vr))[..., None]
    point = take(tri_a) + mix_b * take(tri_e1) + mix_c * take(tri_e2)

    r1 = torch.remainder(h_r1 + off(5), 1.0)
    r2 = torch.remainder(h_r2 + off(6), 1.0)
    sin_t = torch.sqrt(1.0 - r1)
    phi = TWO_PI * r2
    lx = (sin_t * torch.cos(phi))[..., None]
    ly = (sin_t * torch.sin(phi))[..., None]
    lz = torch.sqrt(r1)[..., None]
    normal = take(tri_n)
    direction = lx * take(tri_u) + ly * take(tri_v) + lz * normal
    origin = point + take(tri_eps)[..., None] * normal
    once = n_rays_once.index_select(0, schedule[:, 0].long())
    n_valid = (once - schedule[:, 3]).clamp_(0, sched_block)
    return origin, direction, n_valid


def scheduled_trace(
    scene: Tuple,
    tri_pack: torch.Tensor,
    tables_flat: Tuple,
    geom_stacked: Tuple,
    cp: torch.Tensor,
    surf_active_ext: torch.Tensor,
    emit_sid: torch.Tensor,
    min_sid: torch.Tensor,
    n_rays_once: torch.Tensor,
    plane_vec: torch.Tensor,
    schedule: torch.Tensor,
    sel: torch.Tensor,
    *,
    sched_block: int,
    tri_tile: int = PALLAS_TRI_TILE,
) -> torch.Tensor:
    """Trace a block schedule spanning many emitters and iterations.

    Counterpart of the JAX package's ``scheduled_trace_pallas`` (matrix
    counts): the round's combined mask rows for all its E emitters
    (:func:`combined_masks`), the rays of all nb schedule rows
    (:func:`scheduled_rays`), one multi-emitter sweep over them (kernel
    #2) against ``tri_pack`` (the scene pack built once with zero mask
    rows: one pack serves every emitter), and the per-row counts (the
    count kernel).

    Per-round inputs are indexed by emitter row: ``surf_active_ext`` (E,
    S+1), ``emit_sid``/``min_sid``/``n_rays_once`` (E,), ``plane_vec`` (E,
    8) and ``sel`` (E,), the emitter's row of the solve-wide geometry
    stack. Returns :func:`pack_outputs` of ``counts_b``/``counts_f`` (nb,
    S): one tensor, so the host fetches a round with one copy.
    """
    nb = schedule.shape[0]
    n_surf = surf_active_ext.shape[1] - 1
    if tables_flat[0].shape[0] % sched_block or sched_block % RAY_SUBBLOCK:
        raise ValueError(
            f"flat ray tables ({tables_flat[0].shape[0]} rows) must be a multiple of "
            f"sched_block={sched_block}, itself a multiple of {RAY_SUBBLOCK}"
        )
    masks = combined_masks(scene, surf_active_ext, emit_sid, min_sid, plane_vec)
    o, d, n_valid = scheduled_rays(tables_flat, geom_stacked, cp, n_rays_once,
                                   schedule, sel, sched_block=sched_block)
    emap = schedule[:, 0].repeat_interleave(sched_block // RAY_SUBBLOCK)
    codes, _ = sweep_rays_scheduled(
        ray_pack(o, d), tri_pack, masks, emap, tri_tile=tri_tile,
        want_matrix=True, want_any=False,
    )
    counts_f, counts_b = count_codes(codes.view(nb, sched_block), n_valid, n_surf)
    return pack_outputs({"counts_b": counts_b, "counts_f": counts_f})


def pack_outputs(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Flatten an output dict (all int32) into one tensor in sorted-key
    order, so a round leaves the card in one copy; :func:`unpack_outputs`
    inverts it."""
    return torch.cat([out[k].reshape(-1) for k in sorted(out)])


def unpack_outputs(flat: np.ndarray, nb: int, n_surf: int) -> Dict[str, np.ndarray]:
    """Host-side inverse of :func:`pack_outputs` for the matrix counts
    (NumPy views, no copy)."""
    shapes = {"counts_b": (nb, n_surf), "counts_f": (nb, n_surf)}
    host, off = {}, 0
    for k in sorted(shapes):
        n = int(np.prod(shapes[k]))
        host[k] = flat[off : off + n].reshape(shapes[k])
        off += n
    if off != flat.size:
        raise ValueError(f"packed output size mismatch: {off} != {flat.size}")
    return host


__all__ = [
    "generate_rays", "ray_pack", "compute_masks", "combined_masks", "emitter_operands",
    "chunk_body", "scheduled_rays", "scheduled_trace", "pack_outputs", "unpack_outputs",
]
