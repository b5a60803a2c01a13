"""The QMC solve's device step: ray generation, sweep, per-surface histograms.

Counterpart of ``raystrack_tpu/ops/trace.py`` (``generate_rays``,
``compute_masks``, ``compute_masks_slim``, ``chunk_body_pallas``,
``scheduled_trace_pallas`` and ``pack_outputs``/``unpack_outputs``). Two entry points:

- :func:`chunk_body` traces ``chunk`` Monte-Carlo iterations of one
  emitter (the per-emitter route, sweep kernel #1);
- :func:`scheduled_trace` traces a block schedule that spans many
  emitters and iterations in one dispatch (the scheduled route, sweep
  kernel #2).

Both run

    rays   <- stratified Halton emission with Cranley-Patterson rotation
    sweep  <- all-pairs Möller–Trumbore against the scene (ops/trace_cuda.py)
    reduce <- per-row histograms (count_bins): front/back hits per surface
              for the matrix, and for the sky the rays that miss every
              eligible triangle, upward (merged) or per Tregenza patch
              (discrete)

and return only int32 count tensors. ``want_matrix`` / ``want_any`` /
``discrete`` pick the outputs as in the JAX package: ``counts_f`` and
``counts_b`` for the matrix, ``upward`` or ``sky_bins`` for the sky, both
from one sweep of the same rays in the shared-ray workflow. Everything here
is plain PyTorch on the solve's device; the sweeps, the count and a
scheduled round's mask rows are the kernels.

With the scene's acceleration boxes (``accel``) on a scene of more than
one sweep tile, both first sort each iteration's (or schedule row's) rays
by a Morton key of origin and direction (:func:`sort_rays_for_coherence`),
so each 256-ray block is a tight bundle, and the sweep's AABB distance gate
skips the tiles no ray of a block can reach. The counts are
permutation-invariant, so the sort changes no result.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import PALLAS_TRI_TILE
from ..tracing import spanned
from .count_cuda import count_bins, count_codes
from .masks_cuda import check_mask_args, mask_rows
from .trace_cuda import (
    RAY_SUBBLOCK, build_tri_pack, gate_prunes, sweep_rays, sweep_rays_scheduled,
)
from .tregenza import TREGENZA_BINS, tregenza_patch_id

TWO_PI = 6.283185307179586


@spanned("raystrack.ops.raygen")
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


def _morton3(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Interleave the low ``bits`` (at most 10) of (..., 3) int32 coords into
    one code: bit ``b`` of axis ``a`` lands at bit ``3 * b + a``. The bits
    of all three axes spread at once by shifts and masks, about fifteen
    tensor ops where a loop over bits and axes takes five per bit."""
    x = q & ((1 << bits) - 1)
    if bits > 8:
        x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x[..., 0] | (x[..., 1] << 1) | (x[..., 2] << 2)


def sort_rays_for_coherence(o, d, valid, *, scene_lo, scene_hi):
    """Per-row coherence sort: (o, d, valid) of shapes (R, N, 3), (R, N, 3)
    and (R, N) permuted within each row by a Morton key whose major part
    is the origin quantised to 64 cells per axis of the scene's box and
    whose minor part is the direction quantised to 8 per axis.

    The key and the stable sort are the JAX package's
    (``raystrack_tpu/ops/trace.py`` ``sort_rays_for_coherence``), so both
    put the same rays in each 256-ray block. A block then covers a compact
    origin patch, which is what lets the block-level gate skip tiles.
    """
    dq = torch.clamp((d + 1.0) * 0.5 * 7.9999, 0.0, 7.0).to(torch.int32)
    span = torch.clamp(scene_hi - scene_lo, min=1e-12)
    oq = torch.clamp((o - scene_lo) / span * 63.9999, 0.0, 63.0).to(torch.int32)
    key = (_morton3(oq, 6) << 9) | _morton3(dq, 3)
    perm = torch.argsort(key, dim=1, stable=True)
    take3 = perm[..., None].expand_as(o)
    return o.gather(1, take3), d.gather(1, take3), valid.gather(1, perm)


def _gate_accel(accel, n_tri_pad: int, tri_tile: int):
    """``accel`` where :func:`gate_prunes`, else None: the one decision of
    whether a chunk or round sorts its rays and gates its sweep. The sweep
    wrappers gate only what they are handed, so a caller that did not sort
    never gets a gated sweep."""
    return accel if gate_prunes(accel, n_tri_pad, tri_tile) else None


@spanned("raystrack.ops.gate")
def _sorted_for_gate(o, d, valid, accel):
    """The rays sorted for the gate (:func:`sort_rays_for_coherence` within
    each row, against the scene box of ``accel``)."""
    return sort_rays_for_coherence(o, d, valid, scene_lo=accel[0].amin(dim=0),
                                   scene_hi=accel[1].amax(dim=0))


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


def compute_masks_slim(sid: torch.Tensor, surf_active_ext, emit_sid: int, min_sid: int):
    """Per-triangle masks from the surface ids alone (slim pack-resident
    scenes): :func:`compute_masks` without the per-triangle plane cull,
    which needs the vertex fields a slim scene does not keep on the device.
    Exact: a surface wholly behind the emission plane is already off in
    ``surf_active_ext``, and the per-triangle cull only removes more
    triangles no ray can hit. These masks decide the tiles to skip; the
    kernel's per-pair tests run from the pack's code row."""
    active = surf_active_ext[sid] > 0  # the padding sid n_surf is inactive
    m_any = active & (sid != emit_sid)
    m_mat = m_any & (sid >= min_sid)
    return m_any, m_mat


def combined_masks_reference(scene: Tuple, surf_active_ext, emit_sid, min_sid,
                             plane_vec) -> torch.Tensor:
    """Plain version of the mask rows kernel (``csrc/masks.cu``): the (E,
    Tpad) f32 combined eligibility rows ``m_any + m_mat`` in {0, 1, 2} of E
    emitters at once (m_mat is a subset of m_any).

    Row e equals :func:`compute_masks` of emitter e bitwise: the same ops
    in the same order, broadcast over (E, Tpad). ``surf_active_ext`` is (E,
    S+1) int32, ``emit_sid``/``min_sid`` (E,) int32 and ``plane_vec`` (E,
    8) f32. Each product, sum and difference rounds on its own, and the
    maximum of the three signed distances is NaN where one is, so a
    triangle with a NaN distance is unreachable from a planar emitter.
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


@spanned("raystrack.ops.masks")
def combined_masks(scene: Tuple, surf_active_ext, emit_sid, min_sid,
                   plane_vec) -> torch.Tensor:
    """A scheduled round's (E, Tpad) f32 mask rows, as
    :func:`combined_masks_reference` defines them, bitwise.

    CUDA tensors go to the kernel of ``csrc/masks.cu`` (:func:`mask_rows`:
    one launch on the current stream, not synchronised, counted in
    ``mask_rows.launches``); CPU tensors go to the plain version. Both
    check their arguments (:func:`check_mask_args`).
    """
    if scene[7].device.type == "cuda":
        return mask_rows(scene, surf_active_ext, emit_sid, min_sid, plane_vec)
    check_mask_args(scene, surf_active_ext, emit_sid, min_sid, plane_vec)
    return combined_masks_reference(scene, surf_active_ext, emit_sid, min_sid, plane_vec)


@spanned("raystrack.ops.masks")
def emitter_operands(scene: Tuple, surf_active_ext, emit_sid: int, min_sid: int,
                     plane_vec=None, *, want_any: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sweep operands of one emitter for one kind of dispatch: the
    (24, Tpad) pack with the primary mask baked in (m_any when any-hits are
    wanted, else m_mat, as the JAX package bakes it per dispatch), and that
    mask (Tpad,) bool, which decides the tiles the sweep skips. With
    any-hits wanted the sweep tests the pack's m_mat row for the matrix."""
    m_any, m_mat = compute_masks(scene, surf_active_ext, emit_sid, min_sid, plane_vec)
    primary = m_any if want_any else m_mat
    return build_tri_pack(scene, m_any, m_mat, bake=primary), primary


@spanned("raystrack.ops.masks")
def slim_operands(sid: torch.Tensor, surf_active_ext, emit_sid: int, min_sid: int, *,
                  want_any: bool = False) -> Tuple[torch.Tensor, Tuple[float, float]]:
    """A slim scene's counterpart of :func:`emitter_operands`, beside the
    resident ``ScenePack.tri_pack`` every emitter shares: the primary mask
    (m_any when any-hits are wanted, else m_mat) from the surface ids, which
    decides the tiles the sweep skips, and the sweep's ``code_bounds``
    ``(2 * emit_sid, 2 * min_sid)``."""
    m_any, m_mat = compute_masks_slim(sid, surf_active_ext, emit_sid, min_sid)
    return (m_any if want_any else m_mat), (2.0 * emit_sid, 2.0 * min_sid)


def _count_rows(codes: torch.Tensor, valid, n_valid: torch.Tensor, n_surf: int):
    """count_codes of (rows, L) codes. After a coherence sort the real rays
    no longer lead their rows: the kernel then takes ``valid`` (rows, L) in
    place of ``n_valid`` and counts the rays it marks."""
    if valid is not None:
        return count_codes(codes, None, n_surf, valid=valid)
    return count_codes(codes, n_valid, n_surf)


@spanned("raystrack.ops.count")
def _outputs(codes, any_hit, d, valid, n_valid, n_surf: int, *, want_matrix: bool,
             want_any: bool, discrete: bool) -> Dict[str, torch.Tensor]:
    """The per-row counts of one sweep's (rows, L) ``codes`` and ``any_hit``
    flags, with the rays' (rows, L, 3) directions ``d`` in the sweep's
    order (after the coherence sort, where there was one): ``counts_f`` /
    ``counts_b`` (rows, n_surf) for the matrix; for the sky, of the rays
    that hit no eligible triangle, ``sky_bins`` (rows, 145) per Tregenza
    patch or ``upward`` (rows,) with ``dz > 0``. Each is one count kernel
    over the rays ``valid`` (or the leading ``n_valid``) marks."""
    out: Dict[str, torch.Tensor] = {}
    if want_matrix:
        out["counts_f"], out["counts_b"] = _count_rows(codes, valid, n_valid, n_surf)
    if want_any:
        miss = any_hit == 0
        dz = d[..., 2]
        if discrete:
            ids = torch.where(miss, tregenza_patch_id(d[..., 0], d[..., 1], dz), -1)
            n_bins = TREGENZA_BINS
        else:
            ids = torch.where(miss & (dz > 0.0), 0, -1).to(torch.int32)
            n_bins = 1
        if valid is not None:
            counts = count_bins(ids, n_bins, valid=valid)
        else:
            counts = count_bins(ids, n_bins, n_valid)
        if discrete:
            out["sky_bins"] = counts
        else:
            out["upward"] = counts[:, 0]
    return out


def chunk_body(
    tri_pack: torch.Tensor,
    sweep_mask: torch.Tensor,
    tables: Tuple,
    geom: Tuple,
    cp: torch.Tensor,
    n_surf: int,
    n_rays_once: int,
    accel=None,
    code_bounds=None,
    *,
    ray_index_base: int = 0,
    want_matrix: bool = True,
    want_any: bool = False,
    discrete: bool = False,
) -> Dict[str, torch.Tensor]:
    """Trace ``chunk = cp.shape[0]`` iterations of one emitter.

    Sweeps against the operands of :func:`emitter_operands` for this kind
    of dispatch (gated by the scene's ``accel`` boxes where
    :func:`gate_prunes`, after a coherence sort of each iteration's rays),
    drops padded tail rays, and returns per-iteration counts left on the
    solve's device: ``counts_f`` / ``counts_b`` (chunk, n_surf) int32 when
    ``want_matrix``, ``upward`` (chunk,) or, ``discrete``, ``sky_bins``
    (chunk, 145) int32 when ``want_any``.

    With ``code_bounds`` the operands are a slim scene's: its resident
    ``tri_pack`` and the mask and bounds of :func:`slim_operands`; the
    sweep then takes eligibility from the pack's code row instead of a
    baked pack. The counts are the same.

    ``tables`` may be one shard's contiguous slice of the padded per-ray
    tables (``parallel.sharding.trace_chunk_sharded``): ``ray_index_base``
    is the index of its first ray, so the rays at or past ``n_rays_once``,
    the padding, count nowhere. A shard's real rays are still a prefix of
    its slice, and a shard of padding only counts zero.
    """
    chunk = cp.shape[0]
    n_local = tables[0].shape[0]
    device = cp.device

    o, d = generate_rays(tables, geom, cp)
    valid = None
    accel = _gate_accel(accel, tri_pack.shape[1], PALLAS_TRI_TILE)
    if accel is not None:
        ray = torch.arange(n_local, device=device) + ray_index_base
        valid = (ray < n_rays_once).expand(chunk, n_local)
        o, d, valid = _sorted_for_gate(o, d, valid, accel)
    codes, any_hit = sweep_rays(
        ray_pack(o, d), tri_pack, sweep_mask, tri_tile=PALLAS_TRI_TILE,
        want_matrix=want_matrix, want_any=want_any, masks_baked=code_bounds is None,
        code_bounds=code_bounds, accel=accel,
    )
    n_valid = torch.full((chunk,), min(max(n_rays_once - ray_index_base, 0), n_local),
                         dtype=torch.int32, device=device)
    return _outputs(codes.view(chunk, n_local), any_hit.view(chunk, n_local), d, valid,
                    n_valid, n_surf, want_matrix=want_matrix, want_any=want_any,
                    discrete=discrete)


@spanned("raystrack.ops.raygen")
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

    Each schedule row searches its own copy of its emitter's CDF, so the
    stack's CDF (``geom_stacked[0]``) may be given narrower than the other
    stacks: its first F columns, F at least the faces of every emitter the
    schedule names. A CDF ends in 1.0 and its padding is 1.0, so a query in
    [0, 1] finds the same face there as in the whole row, and the copy
    spans the round's faces, not the stack's widest emitter's.
    """
    cdf_s, tri_a, tri_e1, tri_e2, tri_u, tri_v, tri_n, tri_eps = geom_stacked
    n_geom, f_max = tri_a.shape[:2]
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
    tri_tile: Optional[int] = None,
    accel=None,
    want_matrix: bool = True,
    want_any: bool = False,
    discrete: bool = False,
    pack_out: bool = True,
):
    """Trace a block schedule spanning many emitters and iterations.

    Counterpart of the JAX package's ``scheduled_trace_pallas``: the
    round's combined mask rows for all its E emitters
    (:func:`combined_masks`), the rays of all nb schedule rows
    (:func:`scheduled_rays`; coherence-sorted within each row where the
    scene's ``accel`` boxes let the gate prune), one multi-emitter sweep
    over them (kernel #2) against ``tri_pack`` (the scene pack built once
    with zero mask rows: one pack serves every emitter), and the per-row
    counts (the count kernel, once per output).

    Per-round inputs are indexed by emitter row: ``surf_active_ext`` (E,
    S+1), ``emit_sid``/``min_sid``/``n_rays_once`` (E,), ``plane_vec`` (E,
    8) and ``sel`` (E,), the emitter's row of the solve-wide geometry
    stack. Returns :func:`pack_outputs` of the outputs ``want_matrix`` /
    ``want_any`` / ``discrete`` pick (those of :func:`chunk_body`, per
    schedule row): one tensor, so the host fetches a round with one copy;
    with ``pack_out=False`` the dict itself (a sharded round joins its
    shards' rows before it packs them).
    """
    nb = schedule.shape[0]
    n_surf = surf_active_ext.shape[1] - 1
    tri_tile = tri_tile or PALLAS_TRI_TILE
    if tables_flat[0].shape[0] % sched_block or sched_block % RAY_SUBBLOCK:
        raise ValueError(
            f"flat ray tables ({tables_flat[0].shape[0]} rows) must be a multiple of "
            f"sched_block={sched_block}, itself a multiple of {RAY_SUBBLOCK}"
        )
    masks = combined_masks(scene, surf_active_ext, emit_sid, min_sid, plane_vec)
    o, d, n_valid = scheduled_rays(tables_flat, geom_stacked, cp, n_rays_once,
                                   schedule, sel, sched_block=sched_block)
    valid = None
    accel = _gate_accel(accel, tri_pack.shape[1], tri_tile)
    if accel is not None:
        # rows never mix emitters, so each row sorts on its own
        ray = torch.arange(sched_block, dtype=n_valid.dtype, device=n_valid.device)
        o, d, valid = _sorted_for_gate(o, d, ray[None, :] < n_valid[:, None], accel)
    emap = schedule[:, 0].repeat_interleave(sched_block // RAY_SUBBLOCK)
    codes, any_hit = sweep_rays_scheduled(
        ray_pack(o, d), tri_pack, masks, emap, tri_tile=tri_tile,
        want_matrix=want_matrix, want_any=want_any, accel=accel,
    )
    out = _outputs(
        codes.view(nb, sched_block), any_hit.view(nb, sched_block), d, valid, n_valid,
        n_surf, want_matrix=want_matrix, want_any=want_any, discrete=discrete)
    return pack_outputs(out) if pack_out else out


def pack_outputs(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Flatten an output dict (all int32) into one tensor in sorted-key
    order, so a round leaves the card in one copy; :func:`unpack_outputs`
    inverts it."""
    return torch.cat([out[k].reshape(-1) for k in sorted(out)])


def unpack_outputs(flat: np.ndarray, nb: int, n_surf: int, *, want_matrix: bool = True,
                   want_any: bool = False, discrete: bool = False) -> Dict[str, np.ndarray]:
    """Host-side inverse of :func:`pack_outputs` for the outputs the three
    flags pick (NumPy views, no copy)."""
    shapes = {}
    if want_matrix:
        shapes["counts_b"] = (nb, n_surf)
        shapes["counts_f"] = (nb, n_surf)
    if want_any:
        if discrete:
            shapes["sky_bins"] = (nb, TREGENZA_BINS)
        else:
            shapes["upward"] = (nb,)
    host, off = {}, 0
    for k in sorted(shapes):
        n = int(np.prod(shapes[k]))
        host[k] = flat[off : off + n].reshape(shapes[k])
        off += n
    if off != flat.size:
        raise ValueError(f"packed output size mismatch: {off} != {flat.size}")
    return host


__all__ = [
    "generate_rays", "ray_pack", "sort_rays_for_coherence", "compute_masks",
    "compute_masks_slim", "combined_masks", "combined_masks_reference", "emitter_operands",
    "slim_operands", "chunk_body", "scheduled_rays", "scheduled_trace", "pack_outputs",
    "unpack_outputs",
]
